"""Deterministic input replay: record and play back InputEvent streams
(a copy of raytracing_engine_tpu/runtime/replay.py over the port's
runtime/frame.InputEvent, whose fields are the same).

The reference is driven live by winit events (src/main.rs:682-717); the
headless analog records the per-frame input state to a small JSONL file and
plays it back through FrameLoop. Camera integration (camera.integrate_input)
is pure f32 math with no wall-clock dependence (each event carries its own
dt), so a replayed stream reproduces every camera pose, and therefore every
frame, bit for bit on the same build.

File format (versioned, line-oriented so streams can be appended/truncated),
the same bytes as the JAX package writes, so a session recorded by either
package replays in the other:
  line 1: {"raytracing_engine_tpu_replay": 1}
  line N: one InputEvent as a JSON object; only non-default fields are
          written, so common frames ("just mouse-look") stay short.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Iterator, List

from raytracing_engine_tpu_torch.runtime.frame import InputEvent

_MAGIC = "raytracing_engine_tpu_replay"
_VERSION = 1
_DEFAULTS = InputEvent()


def event_to_dict(ev: InputEvent) -> dict:
    """Sparse dict of an event: only fields differing from the defaults."""
    out = {}
    for f in dataclasses.fields(InputEvent):
        v = getattr(ev, f.name)
        if v != getattr(_DEFAULTS, f.name):
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def event_from_dict(d: dict) -> InputEvent:
    kw = {}
    for f in dataclasses.fields(InputEvent):
        if f.name in d:
            v = d[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return InputEvent(**kw)


def save_replay(path: str, events: Iterable[InputEvent]) -> int:
    """Write an event stream; returns the number of events written."""
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps({_MAGIC: _VERSION}) + "\n")
        for ev in events:
            f.write(json.dumps(event_to_dict(ev), separators=(",", ":")) + "\n")
            n += 1
    return n


def load_replay(path: str) -> List[InputEvent]:
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get(_MAGIC) != _VERSION:
            raise ValueError(f"{path}: not a replay file (or unsupported version: {header})")
        return [event_from_dict(json.loads(line)) for line in f if line.strip()]


class Recorder:
    """Wrap an event stream: passes events through while recording them.

    >>> rec = Recorder()
    >>> loop.run(rec.wrap(live_events))
    >>> rec.save("session.replay")
    """

    def __init__(self):
        self.events: List[InputEvent] = []

    def wrap(self, events: Iterable[InputEvent]) -> Iterator[InputEvent]:
        for ev in events:
            self.events.append(ev)
            yield ev

    def save(self, path: str) -> int:
        return save_replay(path, self.events)
