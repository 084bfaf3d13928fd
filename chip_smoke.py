#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_engine_tpu_torch) on one GPU.

Phases, each printing its own lines:
  1. the card's name and power limit; the CUDA kernels built from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     1920x1088 configuration's shapes (atol 2e-5, rtol 1e-5, at most 1e-4 of
     the elements diverging);
  3. the fused renderer against the two-kernel renderer, bit for bit;
  4. a 64x64 render against tests/golden/golden_64.npz;
  5. the main path at 1920x1088 through its user entry points (FrameLoop,
     render_sequence) under the kernels' launch counters;
  6. CUDA-event timings of each kernel and of the whole frame, beside the
     plain versions.
Then one JSON line of per-kernel results, the card line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line; so does a machine without CUDA or a directory without the repo.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_64.npz"
SIZE = (1920, 1088)

# compiled kernel vs plain version: the repo's compiled-vs-reference bound
# (tests_tpu/test_compiled_kernels.py); isolated silhouette pixels may flip
KERNEL_TOL = dict(atol=2e-5, rtol=1e-5)
KERNEL_FRAC = 1e-4
# against the golden artifact: tests/test_parity_jnp_vs_golden.py
DEPTH_TOL = dict(rtol=1e-4, atol=1e-3)
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)
GOLDEN_FRAC = 1e-3

WALK = 10  # FrameLoop events: W held for 10 frames at dt=0.05
ORBIT = 8  # render_sequence poses
TWO_KERNEL = 2  # render_sequence poses through the two-kernel path
TIMED = 24  # distinct poses for the timings
PLAIN_REPS = 5  # per-kernel plain-version timings (each is a slow loop)
PLAIN_FRAMES = 20  # plain-renderer frames timed (of the TIMED poses)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def diverging(got, want, atol, rtol):
    """(max abs error, fraction of elements outside atol + rtol*|want|)."""
    got, want = got.double(), want.double()
    bad = ~torch.isclose(got, want, atol=atol, rtol=rtol)
    return (got - want).abs().max().item(), bad.double().mean().item()


def hold(label: str, got, want, tol, frac_limit):
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err, frac = diverging(got, want, **tol)
    log(f"  {label}: max_abs_err={err:.6g} diverging={frac:.6g} (limit {frac_limit:g})")
    if frac > frac_limit:
        raise AssertionError(f"{label}: {frac:.4%} of elements diverge")
    return err


def phase_build():
    from raytracing_engine_tpu_torch.ops.cuda import common

    info = common.build()
    for line in info["log"].splitlines():
        if "ptxas info" in line and ("registers" in line or "entry function" in line):
            log(f"  {line.strip()}")
    common.library()
    log(f"build: {'built' if info['built'] else 'up to date'} in {info['seconds']:.2f} s "
        f"(nvcc, sm_90a, --fmad=false)")


def phase_kernels(cfg, scene, pos, quat):
    """Each kernel vs its plain version on the same inputs; → max errors."""
    from raytracing_engine_tpu_torch.models import conemarch
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade

    plain = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    errs = {"depth": 0.0}
    for i in range(cfg.level_count):
        prev = plain[i - 1] if i else None
        got = depth.depth_level(cfg, i, scene, pos, quat, prev)
        want = depth.depth_level_reference(cfg, i, scene, pos, quat, prev)
        err = hold(f"K1 depth level {i} {tuple(got.shape)}", got, want, KERNEL_TOL, KERNEL_FRAC)
        errs["depth"] = max(errs["depth"], err)
    errs["shade"] = hold(
        "K3 shade", shade.shade(cfg, scene, pos, quat, plain[-1]),
        shade.shade_reference(cfg, scene, pos, quat, plain[-1]), KERNEL_TOL, KERNEL_FRAC)
    errs["fused"] = hold(
        "K2 fused", fused.depth_shade_fused(cfg, scene, pos, quat, plain[-2]),
        fused.fused_reference(cfg, scene, pos, quat, plain[-2]), KERNEL_TOL, KERNEL_FRAC)
    return errs


def phase_fused_bitwise(cfg, scene, pos, quat):
    from raytracing_engine_tpu_torch.models import cuda_renderer

    one = cuda_renderer.render(cfg, scene, pos, quat, fused=True)
    two = cuda_renderer.render(cfg, scene, pos, quat, fused=False)
    if not torch.equal(one, two):
        raise AssertionError("fused != two-kernel: "
                             f"{(one != two).double().mean().item():.6g} of elements differ")
    log(f"  fused == two-kernel bit for bit at {cfg.width}x{cfg.height}")


def phase_golden(device):
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import cuda_renderer

    z = np.load(GOLDEN)
    cfg = rtt.RenderConfig(width=64, height=64)
    scene = rtt.default_scene(device)
    pos = torch.from_numpy(z["pos"]).to(device)
    quat = torch.from_numpy(z["quat"]).to(device)
    levels = cuda_renderer.render_depth_pyramid(cfg, scene, pos, quat)
    for i, got in enumerate(levels):
        want = torch.from_numpy(z[f"level_{i}"]).to(device)
        hold(f"golden level {i}", got, want, DEPTH_TOL, GOLDEN_FRAC)
    img = cuda_renderer.render(cfg, scene, pos, quat)
    hold("golden image", img, torch.from_numpy(z["image"]).to(device), IMAGE_TOL, GOLDEN_FRAC)


def nonzero_fraction(img_hwc) -> float:
    return (img_hwc.amax(dim=-1) > 0).double().mean().item()


def phase_main_path(cfg, scene):
    """The user entry points at full size, under the launch counters."""
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent, render_sequence

    device = scene.device
    loop = FrameLoop(cfg, scene)
    frames = []

    def sink(i, img):
        frames.append((img, loop.camera.position.clone(), loop.camera.quat()))

    depth.launches = shade.launches = fused.launches = 0
    loop.run([InputEvent(move=(0, 1, 0), dt=0.05)] * WALK, sink=sink)
    positions, rotations = orbit_path(ORBIT)
    quats = Camera(positions, rotations).quat()
    seq = render_sequence(cfg, scene, positions, quats)
    two = render_sequence(cfg, scene, positions[:TWO_KERNEL], quats[:TWO_KERNEL],
                          fn=functools.partial(cuda_renderer.render, fused=False))
    torch.cuda.synchronize(device)
    counts = {"depth": depth.launches, "fused": fused.launches, "shade": shade.launches}

    end = loop.camera.position.numpy()
    log(f"  FrameLoop: {len(frames)} frames, camera ends at {end.tolist()}")
    if len(frames) != WALK or not np.allclose(end, [0.0, 12.5, 0.0], atol=1e-5):
        raise AssertionError("FrameLoop walk did not end at (0, 12.5, 0)")
    fracs = []
    for i, (img, p, q) in enumerate(frames):
        img = torch.from_numpy(img).to(device)
        want_img = conemarch.render(cfg, scene, p.to(device), q.to(device))
        hold(f"FrameLoop frame {i} vs plain renderer", img, want_img, KERNEL_TOL, KERNEL_FRAC)
        fracs.append(nonzero_fraction(img))
    log(f"  FrameLoop nonzero-pixel fractions: {[round(f, 4) for f in fracs]}")
    # frames 0-2 see the spheres; from y = 3.75 on the walk has passed them all
    if not 0.0 < fracs[0] < 1.0 or not all(f < 1.0 for f in fracs):
        raise AssertionError("FrameLoop frames are empty or saturated")

    if tuple(seq.shape) != (ORBIT, 3, cfg.height, cfg.width):
        raise AssertionError(f"render_sequence shape {tuple(seq.shape)}")
    if not torch.isfinite(seq).all():
        raise AssertionError("render_sequence: non-finite pixels")
    orbit_fracs = [nonzero_fraction(f.permute(1, 2, 0)) for f in seq]
    log(f"  render_sequence {tuple(seq.shape)}; nonzero-pixel fractions "
        f"{[round(f, 4) for f in orbit_fracs]}")
    if not all(0.0 < f < 1.0 for f in orbit_fracs):
        raise AssertionError("an orbit frame is empty or saturated")
    if not torch.equal(two, seq[:TWO_KERNEL]):
        raise AssertionError("two-kernel render_sequence != fused render_sequence")
    log(f"  render_sequence two-kernel == fused bit for bit ({TWO_KERNEL} poses)")

    n_fused = WALK + ORBIT
    want = {"depth": (cfg.level_count - 1) * n_fused + cfg.level_count * TWO_KERNEL,
            "fused": n_fused, "shade": TWO_KERNEL}
    log(f"  launches {counts} (expected {want}: {cfg.level_count - 1} K1 + 1 K2 per fused "
        f"frame x {n_fused}, {cfg.level_count} K1 + 1 K3 per two-kernel frame x {TWO_KERNEL})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts


def cuda_ms(fn, reps: int) -> tuple[float, float]:
    """Mean ms of fn(k), k = 0..reps-1, enqueued back to back: (by CUDA
    events, by the host clock until the last call returned — the enqueue
    time; near the event time, the host is what bounds the loop)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for k in range(reps):
        fn(k)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def phase_timing(cfg, scene, card):
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.utils.timing import conemarch_ray_count

    device = scene.device
    positions, rotations = orbit_path(TIMED, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)
    poses = [(positions[k], quats[k]) for k in range(TIMED)]
    last = cfg.level_count - 1

    def coarse(level_fn, k):
        prev = None
        for i in range(last):
            prev = level_fn(cfg, i, scene, *poses[k], prev)
        return prev

    prevs = [coarse(depth.depth_level, k) for k in range(TIMED)]
    finest = [depth.depth_level(cfg, last, scene, *poses[k], prevs[k]) for k in range(TIMED)]
    torch.cuda.synchronize(device)

    def timed(label, kernel_fn, plain_fn, plain_reps):
        kernel_fn(0)  # warm-up
        plain_fn(0)
        ms, host_ms = cuda_ms(kernel_fn, TIMED)
        plain_ms, _ = cuda_ms(plain_fn, plain_reps)
        log(f"  {label}: kernel {ms:.4f} ms (host enqueue {host_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms (x{plain_ms / ms:.1f}) [{card}]")
        return ms, plain_ms

    t = {}
    t["depth"] = timed(f"K1 x{last} levels per frame",
                       lambda k: coarse(depth.depth_level, k),
                       lambda k: coarse(depth.depth_level_reference, k), PLAIN_REPS)
    t["fused"] = timed("K2 fused finest level",
                       lambda k: fused.depth_shade_fused(cfg, scene, *poses[k], prevs[k]),
                       lambda k: fused.fused_reference(cfg, scene, *poses[k], prevs[k]),
                       PLAIN_REPS)
    t["shade"] = timed("K3 shade",
                       lambda k: shade.shade(cfg, scene, *poses[k], finest[k]),
                       lambda k: shade.shade_reference(cfg, scene, *poses[k], finest[k]),
                       PLAIN_REPS)
    frame_ms, plain_frame_ms = timed(
        f"frame {cfg.width}x{cfg.height}",
        lambda k: cuda_renderer.render(cfg, scene, *poses[k]),
        lambda k: conemarch.render(cfg, scene, *poses[k]), PLAIN_FRAMES)
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    rays = primary + secondary
    log(f"  renderer {cfg.width}x{cfg.height}, {TIMED} chained frames with distinct poses: "
        f"kernels {frame_ms:.4f} ms/frame = {rays / frame_ms / 1e3:.2f} Mrays/s; "
        f"plain ({PLAIN_FRAMES} frames) {plain_frame_ms:.4f} ms/frame = "
        f"{rays / plain_frame_ms / 1e3:.2f} Mrays/s "
        f"({primary} primary + {secondary} shadow rays per frame) [{card}]")
    t["frame"] = (frame_ms, plain_frame_ms)
    profile_frames(cfg, scene, poses, frame_ms, card)
    return t


def profile_frames(cfg, scene, poses, frame_ms, card):
    """Device time by kernel and pyramid level over the timed poses, from
    torch.profiler; the busy share is that device time over the unprofiled
    event-timed frame."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.models import cuda_renderer

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: cuda_renderer.render(cfg, scene, *poses[k]), TIMED)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        log("  profiler: no device events; device time by kernel not measured")
        return
    n_levels = cfg.level_count - 1
    depth_us = [e.time_range.elapsed_us() for e in events if "depth_kernel" in e.name]
    fused_us = [e.time_range.elapsed_us() for e in events if "fused_kernel" in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in events) / TIMED
    levels = [sum(depth_us[i::n_levels]) / TIMED for i in range(n_levels)]
    log(f"  profile ({TIMED} frames, profiler on: {prof_ms:.4f} ms/frame): device busy "
        f"{busy_us:.1f} us/frame = {busy_us / 1e3 / frame_ms:.1%} of the unprofiled "
        f"{frame_ms:.4f} ms frame; K2 {sum(fused_us) / TIMED:.1f} us; K1 by level "
        f"{[round(x, 1) for x in levels]} us [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import raytracing_engine_tpu_torch as rtt

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"  card: {card}")
    phase_build()

    cfg = rtt.RenderConfig(width=SIZE[0], height=SIZE[1])
    scene = rtt.default_scene(device)
    z = np.load(GOLDEN)
    pos = torch.from_numpy(z["pos"]).to(device)
    quat = torch.from_numpy(z["quat"]).to(device)

    log(f"phase 2: kernels vs plain versions at {cfg.width}x{cfg.height}, "
        f"levels {list(cfg.level_dims)}")
    errs = phase_kernels(cfg, scene, pos, quat)
    log("phase 3: fused vs two-kernel")
    phase_fused_bitwise(cfg, scene, pos, quat)
    log("phase 4: 64x64 against tests/golden/golden_64.npz")
    phase_golden(device)
    log(f"phase 5: main path at {cfg.width}x{cfg.height} (FrameLoop, render_sequence)")
    counts = phase_main_path(cfg, scene)
    log("phase 6: timing (CUDA events)")
    times = phase_timing(cfg, scene, card)

    src = "raytracing_engine_tpu_torch/csrc/conemarch.cu"
    kernels = [
        {"name": "depth_kernel (K1)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/depth.py:98",
         "launches": counts["depth"], "max_abs_err": errs["depth"],
         "ms": times["depth"][0], "plain_ms": times["depth"][1]},
        {"name": "fused_kernel (K2)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/fused.py:30",
         "launches": counts["fused"], "max_abs_err": errs["fused"],
         "ms": times["fused"][0], "plain_ms": times["fused"][1]},
        {"name": "shade_kernel (K3)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/shade.py:194",
         "launches": counts["shade"], "max_abs_err": errs["shade"],
         "ms": times["shade"][0], "plain_ms": times["shade"][1]},
    ]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
