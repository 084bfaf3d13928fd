"""Profiling and tracing hooks (raytracing_engine_tpu/utils/profiling.py).

The reference's only instrumentation is an FPS print (src/main.rs:730).
Here: a torch.profiler trace for device timelines (a Chrome trace, viewable
in Perfetto or chrome://tracing), named stage annotations, and a frame-stat
recorder that produces structured per-frame reports (rays, ms, Mrays/s).
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str, *, warmup: int = 0):
    """Capture a torch.profiler trace of the CPU and, where there is one,
    the CUDA device, written into ``logdir`` as a Chrome trace
    (``*.pt.trace.json``). Yields the profiler, whose ``key_averages()``
    and ``events()`` give the device time by name.

    warmup > 0: the block runs warmup + 1 steps, each ended by
    ``prof.step()``, and only the last is kept: the first device events of
    a trace can go missing on the H100 (the profiler's own warm-up rule)."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    steps = schedule(wait=0, warmup=warmup, active=1, repeat=1) if warmup else None
    with profile(activities=activities, schedule=steps,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def stage(name: str):
    """Annotate a named stage inside a device_trace."""
    with torch.profiler.record_function(name):
        yield


class FrameRecorder:
    """Structured per-frame stats: the FPS print, grown up. A frame's time
    is the host clock around the ``frame()`` block: synchronize CUDA before
    the block ends when it launches device work."""

    def __init__(self, primary_rays: int, secondary_rays: int):
        self.primary = primary_rays
        self.secondary = secondary_rays
        self.frames = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.frames.append(dt)

    def report(self) -> dict:
        if not self.frames:
            return {}
        total = self.primary + self.secondary
        best = min(self.frames)
        mean = sum(self.frames) / len(self.frames)
        return {
            "frames": len(self.frames),
            "best_ms": round(best * 1e3, 3),
            "mean_ms": round(mean * 1e3, 3),
            "fps_best": round(1.0 / best, 1),
            "mrays_best": round(total / best / 1e6, 1),
            "primary_rays": self.primary,
            "secondary_rays": self.secondary,
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
