"""The port's input replay (runtime/replay.py) and video output
(utils/video.py) against the JAX package's on the CPU.

- Replay files: the same events give byte-identical files through both
  packages' save_replay, and each package loads the other's; the sparse
  round trip, the refusal of a file that is not a replay, Recorder's
  passthrough.
- FrameLoop replay at 64x48 on the CPU (the plain cone-march renderer),
  frame by frame and chunked: every replayed frame bit for bit the recorded
  run's, through focus loss and regain and a fullscreen toggle.
- VideoWriter (y4m) and ApngWriter: the same bytes as JAX's writers for the
  same numpy-seeded frames; read_y4m and read_apng equal to JAX's readers;
  APNG exact and y4m within 3 LSB of to_srgb_u8 (tests/test_replay_video.py:
  90-105); a mid-stream resize refused, and a tensor that is not on the CPU
  (a meta tensor stands in for a CUDA frame) refused before any byte is
  written.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. chip_smoke.py phase 17 drives the same
modules on the card at 1920x1088.
"""

import numpy as np
import pytest
import torch

from raytracing_engine_tpu.runtime import replay as jax_replay
from raytracing_engine_tpu.runtime.frame import InputEvent as JInputEvent
from raytracing_engine_tpu.utils import video as jax_video

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch import runtime, utils
from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent
from raytracing_engine_tpu_torch.runtime.replay import (
    Recorder,
    event_from_dict,
    event_to_dict,
    load_replay,
    save_replay,
)
from raytracing_engine_tpu_torch.utils import video
from raytracing_engine_tpu_torch.utils.image import to_srgb_u8

torch.set_num_threads(1)
WRITERS = {"y4m": ("VideoWriter", "read_y4m", "clip.y4m"),
           "apng": ("ApngWriter", "read_apng", "clip.apng")}


def events(cls=InputEvent):
    return [
        cls(move=(1.0, 0.0, 0.0), dt=0.02),
        cls(rot=(0.0, 1.0), cursor=(3.0, -2.0), dt=0.016),
        cls(),  # all defaults -> serializes to {}
        cls(focus=False),
        cls(focus=True, move=(0.0, -1.0, 1.0)),
        cls(resize=(96, 64)),
        cls(fullscreen_toggle=True),
        cls(fullscreen_toggle=True),
        cls(quit=True),
    ]


def test_replay_files_match_jax(tmp_path):
    """Byte-identical files; each package loads the other's."""
    mine, theirs = tmp_path / "port.replay", tmp_path / "jax.replay"
    assert save_replay(str(mine), events()) == len(events())
    jax_replay.save_replay(str(theirs), events(JInputEvent))
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_text().splitlines()[0] == '{"raytracing_engine_tpu_replay": 1}'
    assert load_replay(str(theirs)) == events()
    assert jax_replay.load_replay(str(mine)) == events(JInputEvent)
    assert [event_to_dict(e) for e in events()] == [
        jax_replay.event_to_dict(e) for e in events(JInputEvent)]


def test_sparse_round_trip_refusal_and_recorder(tmp_path):
    for ev in events():
        assert event_from_dict(event_to_dict(ev)) == ev
    assert event_to_dict(InputEvent()) == {}
    other = tmp_path / "not_a_replay.json"
    other.write_text('{"something": "else"}\n')
    with pytest.raises(ValueError, match="not a replay file"):
        load_replay(str(other))
    rec = Recorder()
    assert list(rec.wrap(iter(events()))) == events()
    assert rec.save(str(tmp_path / "rec.replay")) == len(events())
    assert load_replay(str(tmp_path / "rec.replay")) == events()
    assert (runtime.Recorder, runtime.load_replay, runtime.save_replay) == (
        Recorder, load_replay, save_replay)


@pytest.mark.parametrize("chunk", [None, 2], ids=["frame by frame", "chunked"])
def test_frameloop_replay_is_bit_for_bit(tmp_path, chunk):
    """A recorded FrameLoop run, saved and loaded, replays to the same
    frames bit for bit; the fullscreen toggle switches to the monitor size
    and back. While focus is lost the per-frame loop presents its last
    frame again and the chunked loop skips the event, as the JAX package's
    FrameLoop does."""
    cfg = rtt.RenderConfig(width=64, height=48)
    scene = rtt.default_scene(device="cpu")
    stream = [InputEvent(move=(1.0, 1.0, 0.0), cursor=(5.0, 2.0), dt=0.02),
              InputEvent(rot=(1.0, 0.0), dt=0.02),
              InputEvent(focus=False), InputEvent(focus=True, move=(0.0, -1.0, 1.0), dt=0.02),
              InputEvent(fullscreen_toggle=True), InputEvent(rot=(0.0, 1.0), dt=0.02),
              InputEvent(fullscreen_toggle=True)]

    def run(evs, chunk=None):
        frames = {}
        FrameLoop(cfg, scene, monitor=(96, 64)).run(
            evs, sink=lambda i, img: frames.setdefault(i, img), chunk=chunk)
        return frames

    rec = Recorder()
    recorded = run(rec.wrap(stream))
    path = str(tmp_path / "s.replay")
    rec.save(path)
    replayed = run(load_replay(path), chunk)
    assert list(recorded) == list(range(7)) and np.array_equal(recorded[2], recorded[1])
    assert [f.shape for f in recorded.values()] == [(48, 64, 3)] * 4 + [(64, 96, 3)] * 2 + [
        (48, 64, 3)]
    assert list(replayed) == ([0, 1, 3, 4, 5, 6] if chunk else list(range(7)))
    for i, frame in replayed.items():
        assert frame.dtype == np.float32 and np.array_equal(frame, recorded[i]), i
    assert all(f.max() > 0 for f in recorded.values())


def seeded_frames(seed, n, h, w):
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(-0.1, 1.2, (h, w, 3)).astype(np.float32) for _ in range(n)]
    frames[0][:2, :3] = 5.0  # clipped highlights
    return frames


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_writers_match_jax(tmp_path, fmt):
    """The same bytes as JAX's writer (float frames, a CPU tensor, and for
    APNG a u8 frame); the reader equal to JAX's; the round trip within its bound."""
    writer, reader, name = WRITERS[fmt]
    frames = seeded_frames(3, 4, 24, 40)
    # ApngWriter also takes u8 frames as they are; VideoWriter takes floats
    last = to_srgb_u8(frames[3]) if fmt == "apng" else frames[3]
    ins = [frames[0], torch.from_numpy(frames[1]), frames[2], last]
    mine, theirs = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    with getattr(video, writer)(str(mine), fps=25) as w:
        for f in ins:
            w.add(f)
    assert w.frames == 4
    with getattr(jax_video, writer)(str(theirs), fps=25) as jw:
        for f in ins[:1] + [frames[1]] + ins[2:]:
            jw.add(f)
    assert mine.read_bytes() == theirs.read_bytes()
    got, fps = getattr(video, reader)(str(mine))
    want, want_fps = getattr(jax_video, reader)(str(mine))
    assert fps == want_fps == 25 and got.dtype == np.uint8 and np.array_equal(got, want)
    assert got.shape == (4, 24, 40, 3)
    for f, g in zip(frames, got):
        err = np.abs(g.astype(int) - to_srgb_u8(f).astype(int)).max()
        assert err == 0 if fmt == "apng" else err <= 3
    assert (utils.VideoWriter, utils.ApngWriter, utils.read_y4m, utils.read_apng) == (
        video.VideoWriter, video.ApngWriter, video.read_y4m, video.read_apng)


def test_writers_refuse_resize_and_off_cpu_tensors(tmp_path):
    """A mid-stream resize raises in both writers; a tensor off the CPU is
    refused with a call to .cpu() and writes nothing."""
    for writer, _, name in WRITERS.values():
        w = getattr(video, writer)(str(tmp_path / name))
        w.add(np.zeros((16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="constant-size"):
            w.add(np.zeros((16, 32, 3), np.float32))
        w.close()
        fresh = tmp_path / f"meta_{name}"
        w = getattr(video, writer)(str(fresh))
        with pytest.raises(ValueError, match=r"call \.cpu\(\) first"):
            w.add(torch.empty((16, 16, 3), device="meta"))
        w.close()
        assert not fresh.exists() and w.frames == 0
