#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_engine_tpu_torch) on one GPU.

Phases, each printing its own lines:
  1. the card's name and power limit; the CUDA kernels built from csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     1920x1088 configuration's shapes (atol 2e-5, rtol 1e-5, at most 1e-4 of
     the elements diverging); K1, the pyramid in one launch, bit for bit
     against the plain pyramid at every level, at 1920x1088 and 1280x720, for
     levels 0..N-1 and 0..N-2 in one launch and for each level alone;
  3. the fused renderer against the two-kernel renderer, bit for bit;
  4. a 64x64 render against tests/golden/golden_64.npz;
  5. the main path at 1920x1088 through its user entry points (FrameLoop,
     render_sequence) under the kernels' launch counters;
  6. CUDA-event timings of each kernel and of the whole frame (host enqueue
     beside), beside the plain versions and each kernel's least time
     (utils/timing.bound_ms); K1's device time a frame by torch.profiler;
  7. the path tracer's kernel K4 against its plain version on the card at
     BASELINE config 2 (material_spheres, 800x608, 4 bounces, 4 spp) and one
     config-4 chunk (cornell_box, 256x256, 4 bounces, 128 spp), held to the
     repo's megakernel-vs-wavefront bounds (tests/test_megakernel.py:37-40:
     < 1% of pixels off by more than 1e-3, mean difference < 1e-4, ray
     counts within max(8, 1e-3 n)), and whether the match is bitwise; then
     K4's instantiation without a mesh on a band ragged in both directions
     (509 columns, an odd row count) at 3 spp with Russian roulette, bit for
     bit (phases 11 and 14 do the same for the cluster and instance
     instantiations);
  8. physics and invariants through K4: furnace corners at 1.0 (atol 1e-4),
     bands equal to the rows of the full render bit for bit, the first two
     128-spp chunks of progressive_render equal to one 256-spp render within
     the float-summation bound, glass Cornell finite and lit;
  9. the path tracer's main path under the launch counter, timed by CUDA
     events: config 2 frames with distinct camera z (and their device time
     by torch.profiler), config 4's 1024 spp through progressive_render,
     material_spheres at 1920x1088 and 4 spp; then the plain version's
     config-2 frame, K4's device time of a config-2 frame (the profiler's)
     and K4's least times at config 2 and at 1080p;
 10. BASELINE config 3's ClusterSet (the 70,400-triangle torus knot of
     benchmarks/run_all.py:120-148, built on the host, BVH builder named)
     and kernel K6 against its plain version on the card, bit for bit: the
     512x512 camera rays and the bounce-1 rays of one pass (closest hit with
     attributes), NEE-style shadow rays (any hit, t_max = 0.999 of the
     light distance), and axis-parallel and parked rays against a padded
     set; K6 timed by CUDA events;
 11. the config-3 path and its invariants at 512x512, 2 bounces, 1 spp,
     seed_from_int(1): render_pt_rebin (K5) == render_pt_mega(bvh=cs) (K4)
     bit for bit in every regroup mode; K5 and K4 against their plain
     versions on the whole frame, within the megakernel bounds (K4's replay
     counts the work of its least time), and 64-row bands of both bit for
     bit the rows of the full render; render_pt_fast(bvh=cs) through K6
     within the megakernel bounds of K4; progressive_render(bvh=cs) in two chunks
     against one render; K4's cluster instantiation on a ragged band (509
     columns, 5 rows) at 3 spp with Russian roulette against its plain
     version bit for bit; then K5's warp sweep on the rays where it can
     break, one bounce on a state of them against the plain version bit for
     bit: rays at the knot's shared vertices and edges, rays
     grazing its cluster boxes, a warp whose lanes pick different visit-order
     rows, and the duplicated icosphere of tests/test_torch_cluster.py (every
     hit an exact tie) hit at its vertices and by axis-parallel and parked
     rays; every set ends in a ragged warp;
 12. the config-3 main path under the launch counters, timed by CUDA events:
     render_pt_rebin at 512x512 and 1920x1088 (chained frames with distinct
     camera z, best of 3 rounds, host enqueue beside), its torch.profiler
     split (K5 per bounce, sort, permute, un-permute), render_pt_mega(bvh=cs)
     at 512x512, render_pt_fast(bvh=cs), progressive_render(bvh=cs); then K5
     per bounce alone (the profiler's device time), K4 alone on the frame
     of phase 11 and the K4 / K5 / K6 least times;
 13. config 3's mesh as a raw BVH (accel.build_bvh) and kernel K8 against
     its plain version on the card, bit for bit: the 512x512 camera rays and
     the bounce-1 rays (closest hit), the NEE-style shadow rays (any hit,
     t_max = 0.999 of the light distance), axis-parallel and parked rays,
     the duplicated icosphere (every hit a tie) at its vertices and edges,
     walks cut at max_steps = 7 (the icosphere) and 24 (the camera rays),
     and ragged ray counts through the knot (a 13 x 509 band and 507 rays of
     the middle row, neither a whole number of warps); K8 timed on the camera, bounce-1 and shadow rays (device time
     by torch.profiler), beside K6 on the camera rays, and K8's least time;
 14. BASELINE config 5 (benchmarks/run_all.py:317-500: 30 instances of a
     35,200-triangle torus knot, 1,056,000 triangles) and kernel K7 against
     its plain version, bit for bit: on 2 x 2 instances of the knot at
     512x512 (closest with normals, then render_instanced_phong's shadow
     rays from those hits, misses and back faces parked) and on
     axis-parallel and parked rays against two scaled instances;
     render_instanced_phong (hard and soft shadows) through K7 against its
     plain version on a band of the 1920x1088 frame at the full 30
     instances (the instances its rows hit logged), bands equal to the rows
     of the full frame; the path-traced cell at 512x512: render_pt_rebin ==
     render_pt_mega(bvh=InstancedClusters) in every regroup mode, the 2 rows
     whose camera rays hit the most instances through K4 and K5 equal to the
     rows of the full frame and K5 against its plain version there, K4
     against its plain version on the whole frame (its replay counts the
     work of K4's least time), render_pt_fast(bvh=InstancedClusters)
     through K7 against K4; K4's instance instantiation on a ragged band
     (509 columns, 5 rows) of two scaled icosphere instances at 3 spp with
     Russian roulette against its plain version bit for bit; then K7's and K5's
     warp sweeps with instances on the rays
     where they can break, bit for bit: rays at the world vertices and edges of the knot instances, rays grazing
     the instances' world boxes, two instances of the duplicated icosphere
     (ties) hit at their vertices and by axis-parallel and parked rays,
     each set ending in a ragged warp;
 15. the slice's main paths under the launch counters, timed by CUDA events
     (best of 3 rounds, host enqueue beside): the config-5 Phong orbit (8
     chained 1920x1088 frames, hard shadows), its soft-shadow orbit (4
     frames), the config-5 path-traced cell through render_pt_rebin and
     render_pt_mega (then K4 alone on the frame of phase 14, beside its
     least time), config 3 through render_pt_fast with the raw BVH; the
     torch.profiler split (K7 closest against any hit per Phong frame, K5
     per bounce); then K7 alone on a full Phong frame's camera rays (the
     profiler's device time), held to its plain version bit for bit, and
     its least time;
 16. kernel K9 (threefry2x32 uniforms) against its plain version, bit for
     bit, at (8, 1088, 1920) and on a band of rows 517..581, and against
     literal values of jax.random.uniform(PRNGKey(0), ...) and of the JAX
     package's uniform_planes(-7, ...) taken on the CPU; the slice's main
     path under the launch counters: render_pt_fast at BASELINE config 2's
     scene and size (800x608, 4 bounces, 4 spp, PRNGKey(1)) at the default
     rng="threefry", then at rng="pallas", timed by CUDA events, their mean
     against K4's pcg render of the same scene, a band of trace_pass_soa
     against the rows of the full pass bit for bit; progressive_render's
     default route (render_pt_fast with the state's key) chunk-invariant at
     config 4, and through config 3's ClusterSet (K6 and K9) and raw BVH
     (K8 and K9); K9 timed by CUDA events and by torch.profiler, beside its
     plain version, its least time and torch.rand (Philox, another stream,
     for scale only).
Then one JSON line of per-kernel results, each number measured in this run
but the bounds, computed from its inputs (K4 once per instantiation, on its
main path's frames: without a mesh at config 2, with clusters at config 3
and with instances at config 5, each 512x512 frame's bound from the work
its plain version counts); the card line, and as the last
line {"ok": true, "device": {...}}. Any failure exits
non-zero before the last line; so does a machine without CUDA or a
directory without the repo.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_64.npz"
SIZE = (1920, 1088)
K1_SIZE = (1280, 720)  # a second pyramid whose levels are not exact doubles

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

# the path tracer: BASELINE config 2 (benchmarks/run_all.py:89-117) and
# config 4 (:228-266), seed = key_to_seed(PRNGKey(1))
C2 = dict(width=800, height=608, max_bounces=4)
C2_SPP = 4
C4 = dict(width=256, height=256, max_bounces=4)
C4_POS = (0.0, 0.2, 0.0)
C4_CHUNK = 128
C4_SPP = 1024
C2_FRAMES = 8      # chained config-2 frames per timing round
C2_ROUNDS = 3      # timing rounds; the best is kept, as run_all does
PLAIN_PT_FRAMES = 2
HD = dict(width=1920, height=1088, max_bounces=4)  # BASELINE.json's 1080p axis
BANDS = 4          # config 2 split into this many row bands
# megakernel vs wavefront: tests/test_megakernel.py:37-40
PT_FRAC, PT_MEAN = 0.01, 1e-4
# two sequential float32 sums of the same n non-negative terms differ by at
# most 2 * n * 2^-24 of the total (each add rounds within 2^-24 of a running
# sum that never exceeds it): n = 256 passes
CHUNK_RTOL = 2 * 256 * 2.0 ** -24

# BASELINE config 3 (benchmarks/run_all.py:120-225): the torus knot through
# render_pt_rebin, 2 bounces, 1 spp, NEE, pcg, PRNGKey(1), at 512x512 and
# 1920x1088; camera at the origin (frame z offsets only separate frames)
C3 = dict(width=512, height=512, max_bounces=2)
C3_HD = dict(width=1920, height=1088, max_bounces=2)
C3_LIGHT = (6.0, 4.0, 6.0)  # the light sphere's centre (NEE-style shadow rays)
C3_FRAMES = 8      # chained 512x512 frames per timing round
C3_HD_FRAMES = 4   # chained 1920x1088 frames per timing round
C3_ROUNDS = 3
C3_BAND = (224, 64)  # rows of the band check
C3_CHUNK_RTOL = 2 * 4 * 2.0 ** -24  # the summation bound for n = 4 passes
K6_REPS = 20

# BASELINE config 5 (benchmarks/run_all.py:317-500): 30 instances of a
# 35,200-triangle torus knot, camera at the origin
C5_KNOT = dict(segments=550, sides=32)
C5_GRID = dict(nx=6, ny=5, spacing=4.0, base=(0.0, 14.0, 0.0))
C5_ALBEDO = ((0.8, 0.5, 0.3), (0.4, 0.7, 0.5), (0.5, 0.5, 0.8))
C5_LIGHT = (6.0, 2.0, 8.0)
C5_SIZE = (1920, 1088)
C5_FRAMES = 8        # Phong orbit: yaw = linspace(0, 0.5, 8), hard shadows
C5_SOFT_FRAMES = 4   # soft-shadow orbit
C5_SOFT = dict(light_radius=1.5, shadow_samples=4)
C5_PT = dict(width=512, height=512, max_bounces=2)
C5_PT_FRAMES = 4     # chained path-traced frames per timing round
C5_ROUNDS = 3
C5_BAND = (540, 8)      # Phong rows held to the plain version (30 instances)
# path-traced rows held to the plain K4 and K5 versions: the run of rows
# whose camera rays hit the most instances (the plain two-level sweep costs
# seconds per call, nearly whatever the ray count)
C5_PT_BAND_H = 2
K7_REPS = 10
# a spin kernel of about 1 ms at the H100's clocks: what device_ms's event
# timing enqueues ahead of a launch, so the card waits on no host work
SPIN_CYCLES = 2_000_000
K8_REPS = 20
# node caps that cut walks (phase 13): 7 on the duplicated icosphere; 24 on
# config 3's camera rays, where 1.1% of the rays hit by then against 3.4%
# uncut (the plain traversal on the CPU)
K8_CUT_STEPS = (7, 24)
RAW_FRAMES = 3       # config-3 render_pt_fast frames with the raw BVH per round

# kernel K9 (phase 16): the threefry and pallas streams at config 2
K9_SHAPE = (8, 1088, 1920)
K9_BAND = (517, 64)  # rows of the band check
K9_RAGGED = (3, 17, 33)  # no plane a whole number of the kernel's 256-thread blocks
K9_RAGGED_BAND = (5, 7)
K9_REPS = 50
RNG_FRAMES = 3       # timed render_pt_fast frames per rng mode
RNG_BAND = (304, 64)
# float32 bit patterns of jax.random.uniform(jax.random.PRNGKey(0), K9_SHAPE)
# and of the JAX package's ops/pallas/rng.uniform_planes(-7, *K9_SHAPE) at
# these indices, taken with JAX 0.9.0 on the CPU (jax_threefry_partitionable)
JAX_UNIFORM_KEY0 = {(0, 0, 0): 0x3F729A4E, (0, 0, 1): 0x3F7A8436, (3, 517, 1000): 0x3C458680,
                    (5, 100, 1234): 0x3E984328, (7, 1087, 1919): 0x3E50D0F0}
JAX_PLANES_M7 = {(0, 0, 0): 0x3EE4CB84, (0, 0, 1): 0x3F0468F2, (3, 517, 1000): 0x3E8F6FD0,
                 (5, 100, 1234): 0x3DE93050, (7, 1087, 1919): 0x3F50D1A8}
# the threefry and pallas renders' means against K4's pcg render of the same
# scene: two unbiased estimates of one image at 4 spp, 1.15e-4 and under 5e-5
# apart on the H100; a sanity check only, since every draw of a pass is held
# to the plain version bit for bit
RNG_MEAN_RTOL = 1e-3
C4_DEFAULT_CHUNKS = 2  # progressive_render chunks of 16 passes timed on its default route

# K4 at each mesh kind on a band ragged in both directions (509 columns: 31
# of its 16-wide blocks and 13 more; an odd row count), 3 spp, Russian
# roulette from bounce 1, held to the plain version bit for bit: the warp
# form's loops across passes, ended paths and lanes off the image
RAGGED_W = 509
RAGGED_SPP = 3
RAGGED_RR_START = 1
RAGGED_ROWS = 5
K4_REPS = 9


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
    for name in common.LIBRARIES:
        common.library(name)
    built = ", ".join(f"lib{n}.so" for n in info["built"]) or "up to date"
    log(f"build: {built} in {info['seconds']:.2f} s (one nvcc per source, in parallel; "
        f"sm_90a, --fmad=false)")


def hold_k1(cfg, scene, pos, quat) -> float:
    """K1 against the plain pyramid at every level, bit for bit: levels
    0..N-1 and 0..N-2 in one launch each, and each level alone seeded from
    the plain level before; -> the max abs error (0)."""
    from raytracing_engine_tpu_torch.models import conemarch
    from raytracing_engine_tpu_torch.ops.cuda import depth

    plain = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    n = cfg.level_count
    runs = [(f"0..{n - 1} in one launch", depth.depth_pyramid(cfg, scene, pos, quat)),
            (f"0..{n - 2} in one launch", depth.depth_pyramid(cfg, scene, pos, quat, n - 2))]
    runs.append(("each level alone", tuple(
        depth.depth_level(cfg, i, scene, pos, quat, plain[i - 1] if i else None)
        for i in range(n))))
    err = 0.0
    for label, levels in runs:
        for i, got in enumerate(levels):
            err = max(err, hold(f"K1 {cfg.width}x{cfg.height} levels {label}, level {i} "
                                f"{tuple(got.shape)}", got, plain[i], KERNEL_TOL, KERNEL_FRAC))
            if not torch.equal(got, plain[i]):
                raise AssertionError(f"K1 {label}: level {i} differs from the plain pyramid "
                                     f"on {(got != plain[i]).double().mean().item():.6g} of "
                                     "pixels")
        log(f"  K1 {cfg.width}x{cfg.height} levels {label}: every level bit for bit")
    return err


def phase_kernels(cfg, scene, pos, quat):
    """Each kernel vs its plain version on the same inputs; → max errors."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import conemarch
    from raytracing_engine_tpu_torch.ops.cuda import fused, shade

    plain = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    errs = {"depth": max(hold_k1(cfg, scene, pos, quat),
                         hold_k1(rtt.RenderConfig(*K1_SIZE), scene, pos, quat))}
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
    want = {"depth": n_fused + TWO_KERNEL, "fused": n_fused, "shade": TWO_KERNEL}
    log(f"  launches {counts} (expected {want}: 1 K1 (levels 0..{cfg.level_count - 2}) + 1 K2 "
        f"per fused frame x {n_fused}, 1 K1 (levels 0..{cfg.level_count - 1}) + 1 K3 per "
        f"two-kernel frame x {TWO_KERNEL})")
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
    from raytracing_engine_tpu_torch.ops import march
    from raytracing_engine_tpu_torch.ops.cuda import depth, fused, shade
    from raytracing_engine_tpu_torch.utils.timing import (
        RAY_DIR_OPS,
        bound_ms,
        conemarch_ray_count,
        march_ops,
        shade_ops,
    )

    device = scene.device
    n_obj, n_light = int(scene.obj_count), int(scene.light_count)
    positions, rotations = orbit_path(TIMED, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)
    poses = [(positions[k], quats[k]) for k in range(TIMED)]
    last = cfg.level_count - 1

    def coarse(k):
        """K1: the coarse levels 0..last-1 in one launch -> level last-1."""
        return depth.depth_pyramid(cfg, scene, *poses[k], last - 1)[-1]

    def coarse_plain(k):
        prev = None
        for i in range(last):
            prev = depth.depth_level_reference(cfg, i, scene, *poses[k], prev)
        return prev

    prevs = [coarse(k) for k in range(TIMED)]
    finest = [depth.depth_level(cfg, last, scene, *poses[k], prevs[k]) for k in range(TIMED)]
    torch.cuda.synchronize(device)

    dims = cfg.level_dims  # (w, h) per level
    pixels = cfg.width * cfg.height

    def coarse_work(st):
        """K1 over the coarse levels 0..last-1 in one launch from level 0: it
        writes every level and reads none (a level read back to seed the
        next is the kernel's own traffic, not the function's)."""
        n_bytes = sum(4 * w * h for w, h in dims[:last])
        n_ops = RAY_DIR_OPS * sum(w * h for w, h in dims[:last])
        return n_bytes, n_ops + march_ops(st["march"], n_obj)

    def fused_work(st):
        n_bytes = 4 * dims[last - 1][0] * dims[last - 1][1] + 12 * pixels
        n_ops = (RAY_DIR_OPS * pixels + march_ops(st["march"] + st["shadow"], n_obj)
                 + shade_ops(pixels, n_obj, n_light))
        return n_bytes, n_ops

    def shade_work(st):
        n_ops = (RAY_DIR_OPS * pixels + march_ops(st["shadow"], n_obj)
                 + shade_ops(pixels, n_obj, n_light))
        return 16 * pixels, n_ops

    def timed(label, kernel_fn, plain_fn, plain_reps, work=None, kernel=None):
        """Kernel and plain ms; with `work`, the least time of the kernel's
        work, its operations counted from the march steps the plain version
        took on the same poses (the first plain_reps of them). With `kernel`
        (a kernel launched once a call), ms is that kernel's device time by
        the profiler (device_ms), the event time beside it."""
        kernel_fn(0)  # warm-up
        plain_fn(0)
        ms, host_ms = cuda_ms(kernel_fn, TIMED)
        march.steps.update(march=0, shadow=0)
        plain_ms, _ = cuda_ms(plain_fn, plain_reps)
        out = {"ms": ms, "plain_ms": plain_ms}
        events = ""
        if kernel is not None:
            out["ms"] = device_ms(kernel_fn, TIMED, kernel, setup=lambda k: k % TIMED)
            events = f" device time a call, {ms:.4f} ms by CUDA events"
            ms = out["ms"]
        bound = ""
        if work is not None:
            st = {k: int(v) // plain_reps for k, v in march.steps.items()}
            n_bytes, n_ops = work(st)
            out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
            bound = (f"; bound {out['bound_ms']:.5f} ms by {out['bound_by']} ({n_bytes} B, "
                     f"{n_ops} ops; march steps {st})")
        log(f"  {label}: kernel {ms:.4f} ms{events} (host enqueue {host_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms (x{plain_ms / ms:.1f}){bound} [{card}]")
        return out

    t = {}
    t["depth"] = timed(f"K1 levels 0..{last - 1} per frame (one launch)", coarse, coarse_plain,
                       PLAIN_REPS, coarse_work, kernel="pyramid_kernel")
    t["fused"] = timed("K2 fused finest level",
                       lambda k: fused.depth_shade_fused(cfg, scene, *poses[k], prevs[k]),
                       lambda k: fused.fused_reference(cfg, scene, *poses[k], prevs[k]),
                       PLAIN_REPS, fused_work)
    t["shade"] = timed("K3 shade",
                       lambda k: shade.shade(cfg, scene, *poses[k], finest[k]),
                       lambda k: shade.shade_reference(cfg, scene, *poses[k], finest[k]),
                       PLAIN_REPS, shade_work)
    frame = timed(
        f"frame {cfg.width}x{cfg.height}",
        lambda k: cuda_renderer.render(cfg, scene, *poses[k]),
        lambda k: conemarch.render(cfg, scene, *poses[k]), PLAIN_FRAMES)
    frame_ms, plain_frame_ms = frame["ms"], frame["plain_ms"]
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    rays = primary + secondary
    log(f"  renderer {cfg.width}x{cfg.height}, {TIMED} chained frames with distinct poses: "
        f"kernels {frame_ms:.4f} ms/frame = {rays / frame_ms / 1e3:.2f} Mrays/s; "
        f"plain ({PLAIN_FRAMES} frames) {plain_frame_ms:.4f} ms/frame = "
        f"{rays / plain_frame_ms / 1e3:.2f} Mrays/s "
        f"({primary} primary + {secondary} shadow rays per frame) [{card}]")
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
    depth_us = [e.time_range.elapsed_us() for e in events if "pyramid_kernel" in e.name]
    fused_us = [e.time_range.elapsed_us() for e in events if "fused_kernel" in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in events) / TIMED
    log(f"  profile ({TIMED} frames, profiler on: {prof_ms:.4f} ms/frame): device busy "
        f"{busy_us:.1f} us/frame = {busy_us / 1e3 / frame_ms:.1%} of the unprofiled "
        f"{frame_ms:.4f} ms frame; K2 {sum(fused_us) / max(len(fused_us), 1):.1f} us and K1 "
        f"{sum(depth_us) / max(len(depth_us), 1):.1f} us a launch ({len(fused_us)} and "
        f"{len(depth_us)} launches recorded) [{card}]")


def k4_table_bytes(scene, bvh, pos) -> int:
    """Bytes of the tables K4 reads once for a frame seen from pos: the
    packed scene and, with a mesh, its sweep tables and visit orders."""
    from raytracing_engine_tpu_torch.accel.instancing import InstancedClusters
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.utils.timing import cluster_table_bytes

    n = 4 * sum(t.numel() for t in pt.pack_pt_scene(pt.kernel_scene(scene, bvh)))
    if bvh is None:
        return n
    frame = pt.frame_view(bvh, pos)
    if isinstance(bvh, InstancedClusters):
        cs, extra = bvh.cs, [bvh.inst_tab, frame.iorder, frame.iorders]
    else:
        cs, extra = bvh, [frame.orders, frame.refs]
    tb = cluster.sweep_tables(cs)
    return n + cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, *extra])


def hold_k4_ragged(what, cfg, scene, bvh, pos, quat, seed, row0, rows) -> float:
    """K4 on the ragged band of scene `what` (RAGGED_W columns, rows row0 .. row0 + rows,
    RAGGED_SPP spp, Russian roulette from bounce RAGGED_RR_START) against
    render_pt_mega_reference, bit for bit, through the instantiation of the
    scene's mesh kind; -> the max error (0). A check only: the kernels line
    times K4 on its main paths' frames."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops.cuda import pt

    cfg = dataclasses.replace(cfg, width=RAGGED_W, rr_start=RAGGED_RR_START)
    kw = dict(seed=seed, bvh=bvh, row0=row0, band_h=rows)
    kind = pt.mesh_kind(pt.frame_view(bvh, pos))
    before = dict(pt.mesh_launches)
    got, n_got = pt.render_pt_mega(cfg, scene, pos, quat, RAGGED_SPP, **kw)
    picked = {k: pt.mesh_launches[k] - before[k] for k in before}
    t0 = time.perf_counter()
    want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, RAGGED_SPP, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(got, want) and int(n_got) == int(n_want)
    err = (got - want).abs().max().item()
    most = 2 * RAGGED_SPP * RAGGED_W * rows * (cfg.max_bounces + 1)
    label = (f"K4<{kind}> on a ragged band of {what}, {RAGGED_W}x{rows} (rows {row0}..{row0 + rows}"
             f"), {RAGGED_SPP} spp, Russian roulette from bounce {RAGGED_RR_START}")
    log(f"  {label} vs its plain version: bit for bit {same} (max_abs_err={err:.6g}); rays "
        f"{int(n_got)} == {int(n_want)} (at most {most} without an ended path); lit pixels "
        f"{(got.amax(-1) > 0).double().mean().item():.4f}; launches by kind {picked} (plain "
        f"{plain_ms:.1f} ms)")
    if (not same or not torch.isfinite(got).all() or picked[kind] != 1
            or sum(picked.values()) != 1):
        raise AssertionError(f"{label}: differs from its plain version or took another kind")
    return err


def hold_k4_frame(what, cfg, scene, bvh, pos, quat, seed, k4, n4, device) -> dict:
    """K4's whole 1-spp frame from pos (k4, n4: render_pt_mega's output) against
    render_pt_mega_reference on the same inputs; the plain run's time and the
    work it counts (instance gates and transforms, box and triangle tests:
    K4's, as its frame equals the plain one), from which the frame's least
    time follows; -> the kernels-line numbers but K4's own time."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, instanced_ops, pt_ops

    cluster.work.update(slabs=0, tests=0)
    kinst.work.update(gates=0, transforms=0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, 1, seed=seed, bvh=bvh)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    kind = pt.mesh_kind(pt.frame_view(bvh, pos))
    err = hold_pt(f"K4<{kind}> {what} {cfg.width}x{cfg.height} frame vs its plain version "
                  f"(plain {plain_ms / 1e3:.1f} s)", k4, n4, want, n_want)
    ops = pt_ops(int(n_want), int(scene.sph_count), 0) + instanced_ops(
        kinst.work["gates"], kinst.work["transforms"], cluster.work["slabs"],
        cluster.work["tests"])
    n_bytes = 12 * cfg.width * cfg.height + k4_table_bytes(scene, bvh, pos)
    bound = bound_ms(n_bytes, ops)
    log(f"  K4<{kind}> {what} frame bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B, {ops} "
        f"ops: {kinst.work['gates']} instance gates, {kinst.work['transforms']} transforms, "
        f"{cluster.work['slabs']} box + {cluster.work['tests']} triangle tests, {int(n_want)} "
        f"rays x {int(scene.sph_count)} spheres)")
    return {"max_abs_err": err, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def reset_k4():
    """K4's launch counts, in all and by mesh kind, to 0."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    pt.launches = 0
    pt.mesh_launches.update(dict.fromkeys(pt.mesh_launches, 0))


def pt_setup(device):
    """(quat, seed, config 2 (cfg, scene, pos), config 4 (cfg, scene, pos))."""
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes

    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    c2 = (PTConfig(**C2, rng="pcg"), scenes.material_spheres(device),
          torch.zeros(3, device=device))
    c4 = (PTConfig(**C4, rng="pcg"), scenes.cornell_box(device=device),
          torch.tensor(C4_POS, device=device))
    return quat, seed_from_int(1), c2, c4


def cfg_size(c) -> str:
    return f"{c[0].width}x{c[0].height}"


def hold_pt(label, got, n_got, want, n_want) -> float:
    """Hold a K4 render to its plain version within the megakernel bounds."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} or non-finite pixels")
    d = (got - want).abs().amax(-1).double()
    err, frac, mean = d.max().item(), (d > 1e-3).double().mean().item(), d.mean().item()
    n_got, n_want = int(n_got), int(n_want)
    bitwise = torch.equal(got, want) and n_got == n_want
    log(f"  {label}: max_abs_err={err:.6g} diverging(>1e-3)={frac:.6g} (limit {PT_FRAC}) "
        f"mean_abs={mean:.6g} (limit {PT_MEAN}) rays kernel={n_got} plain={n_want} "
        f"bitwise={bitwise}")
    if frac >= PT_FRAC or mean >= PT_MEAN or abs(n_got - n_want) > max(8, 1e-3 * n_want):
        raise AssertionError(f"{label}: K4 disagrees with its plain version")
    return err


def phase_pt_kernel(quat, seed, c2, c4):
    """K4 vs render_pt_mega_reference on the same inputs, on the card; ->
    the max error, the ragged band's included."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    errs = []
    for label, (cfg, scene, pos), spp in (
            (f"config 2 {cfg_size(c2)} {C2_SPP} spp", c2, C2_SPP),
            (f"config 4 chunk {cfg_size(c4)} {C4_CHUNK} spp", c4, C4_CHUNK)):
        got, n_got = pt.render_pt_mega(cfg, scene, pos, quat, spp, seed=seed)
        want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, spp, seed=seed)
        errs.append(hold_pt(f"K4 {label}", got, n_got, want, n_want))
    cfg, scene, pos = c2
    errs.append(hold_k4_ragged("config 2", cfg, scene, None, pos, quat, seed,
                               cfg.height // 2 - 3, RAGGED_ROWS))
    return max(errs)


def phase_pt_invariants(quat, seed, c2, c4, device):
    """Furnace, bands, chunking and glass, all through the kernel."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    pt.launches = 0
    # furnace (tests/test_megakernel.py:43-49): the corners see the enclosure
    cfg = PTConfig(width=32, height=16, max_bounces=3, rng="pcg")
    img, _ = pt.render_pt_mega(cfg, scenes.furnace_scene(0.5, 1.0, device=device),
                               torch.zeros(3, device=device), quat, 32, seed=seed_from_int(13))
    corners = torch.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    log(f"  furnace 32x16 32 spp: corners {corners.tolist()} (want 1.0, atol 1e-4)")
    if not torch.allclose(corners, torch.ones_like(corners), rtol=0.0, atol=1e-4):
        raise AssertionError("furnace corners are not 1.0")

    # bands: rows row0 .. row0 + band_h of the full render, bit for bit
    cfg, scene, pos = c2
    full, n_full = pt.render_pt_mega(cfg, scene, pos, quat, C2_SPP, seed=seed)
    band_h = cfg.height // BANDS
    bands = [pt.render_pt_mega(cfg, scene, pos, quat, C2_SPP, seed=seed,
                               row0=i * band_h, band_h=band_h) for i in range(BANDS)]
    joined = torch.cat([b[0] for b in bands])
    n_bands = sum(int(b[1]) for b in bands)
    log(f"  bands: {BANDS} x {band_h} rows == full render bit for bit: "
        f"{torch.equal(joined, full)}; rays {n_bands} == {int(n_full)}")
    if not torch.equal(joined, full) or n_bands != int(n_full):
        raise AssertionError("a band render differs from the rows of the full render")

    # chunking: two 128-spp chunks of progressive_render vs one 256-spp call
    cfg, scene, pos = c4
    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    chunks = progressive_render(cfg, scene, state, C4_SPP, passes_per_chunk=C4_CHUNK,
                                render_fn=pt.render_pt_mega)
    state = next(chunks)
    state = next(chunks)
    chunks.close()
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 2 * C4_CHUNK, seed=seed)
    want = one * float(2 * C4_CHUNK)
    err = (state.accum - want).abs().max().item()
    ok = torch.allclose(state.accum, want, rtol=CHUNK_RTOL, atol=0.0)
    log(f"  chunking: progressive_render 2 x {C4_CHUNK} spp vs one {2 * C4_CHUNK}-spp "
        f"render (sums): max_abs_err={err:.6g} within rtol {CHUNK_RTOL:.3g}: {ok}; "
        f"bitwise {torch.equal(state.accum, want)}")
    if state.spp_done != 2 * C4_CHUNK or not ok:
        raise AssertionError("progressive_render depends on the chunking")

    # glass Cornell: finite and lit
    glass = scenes.cornell_box(glass=True, device=device)
    img, n = pt.render_pt_mega(cfg, glass, pos, quat, 16, seed=seed)
    mean = img.mean().item()
    log(f"  glass cornell {cfg_size(c4)} 16 spp: finite {bool(torch.isfinite(img).all())}, "
        f"mean {mean:.4f}, rays {int(n)}")
    if not torch.isfinite(img).all() or not mean > 0.0:
        raise AssertionError("glass Cornell render is non-finite or black")

    want_launches = 1 + 1 + BANDS + 2 + 1 + 1
    log(f"  K4 launches {pt.launches} (expected {want_launches}: furnace, full, {BANDS} "
        f"bands, 2 chunks, 256 spp, glass)")
    if pt.launches != want_launches:
        raise AssertionError(f"K4 launches {pt.launches} != {want_launches}")


def profile_pt_frames(c, quat, seed, device, frame_ms, card):
    """Device time of K4 and of everything on the card over C2_FRAMES frames
    (torch.profiler); the busy share is that time over the unprofiled
    event-timed frame."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops.cuda import pt

    cfg, scene, _ = c
    zs = [torch.tensor([0.0, 0.0, 2e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k], quat, C2_SPP,
                                                         seed=seed), C2_FRAMES)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("  profiler: no device events; K4 device time not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in events) / C2_FRAMES
    k4_us = sum(e.time_range.elapsed_us() for e in events if "pt_kernel" in e.name) / C2_FRAMES
    log(f"  profile config 2 ({C2_FRAMES} frames, profiler on: {prof_ms:.4f} ms/frame): K4 "
        f"{k4_us:.1f} us/frame, device busy {busy_us:.1f} us/frame = "
        f"{busy_us / 1e3 / frame_ms:.1%} of the unprofiled {frame_ms:.4f} ms frame [{card}]")


def phase_pt_main(quat, seed, c2, c4, card, device):
    """The path tracer's main path through its entry points (render_pt_mega,
    progressive_render) under the launch counter, timed by CUDA events."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, pt_ops

    def frames(c, spp, label):
        """Best ms/frame over C2_ROUNDS rounds of C2_FRAMES frames with
        distinct camera z, and the Mrays/s of that round."""
        cfg, scene, _ = c
        zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
        pt.render_pt_mega(cfg, scene, zs[0], quat, spp, seed=seed)  # warm-up
        best = None
        for r in range(C2_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(
                pt.render_pt_mega(cfg, scene, zs[k], quat, spp, seed=seed)[1]), C2_FRAMES)
            n = int(torch.stack(rays).sum()) // C2_FRAMES
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms) "
                f"= {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame [{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best

    reset_k4()
    c2_ms, c2_rays = frames(c2, C2_SPP, f"config 2 {cfg_size(c2)} {C2_SPP} spp")
    profile_pt_frames(c2, quat, seed, device, c2_ms, card)

    cfg, scene, pos = c4
    rays = []

    def counted(*args, **kwargs):
        img, n = pt.render_pt_mega(*args, **kwargs)
        rays.append(n)
        return img, n

    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for state in progressive_render(cfg, scene, state, C4_SPP, passes_per_chunk=C4_CHUNK,
                                    render_fn=counted):
        pass
    end.record()
    end.synchronize()
    c4_s = start.elapsed_time(end) / 1e3
    host_s = time.perf_counter() - t0
    c4_rays = int(torch.stack(rays).sum())
    if state.spp_done != C4_SPP or not torch.isfinite(state.accum).all():
        raise AssertionError("config 4 progressive render incomplete or non-finite")
    c4_bytes = (C4_SPP // C4_CHUNK) * 12 * cfg.width * cfg.height
    c4_bound = bound_ms(c4_bytes, pt_ops(c4_rays, int(scene.sph_count), int(scene.tri_count)))
    log(f"  config 4 {cfg_size(c4)} {C4_SPP} spp via progressive_render ({C4_SPP // C4_CHUNK} "
        f"chunks of {C4_CHUNK}): {c4_s:.4f} s by CUDA events ({host_s:.4f} s host) = "
        f"{C4_SPP / c4_s:.1f} spp/s = {c4_rays / c4_s / 1e6:.2f} Mrays/s, {c4_rays} rays; "
        f"bound {c4_bound[0]:.4f} ms by {c4_bound[1]}; image mean "
        f"{state.accum.mean().item() / C4_SPP:.4f} [{card}]")

    hd = (PTConfig(**HD, rng="pcg"), scenes.material_spheres(device), None)
    hd_ms, hd_rays = frames(hd, C2_SPP, f"material_spheres {cfg_size(hd)} {C2_SPP} spp")
    launches, by_kind = pt.launches, dict(pt.mesh_launches)

    cfg, scene, pos = c2
    pt.render_pt_mega_reference(cfg, scene, pos, quat, C2_SPP, seed=seed)  # warm-up
    plain_ms, _ = cuda_ms(lambda k: pt.render_pt_mega_reference(
        cfg, scene, pos, quat, C2_SPP, seed=seed), PLAIN_PT_FRAMES)
    table_bytes = 4 * sum(t.numel() for t in pt.pack_pt_scene(scene))
    c2_bytes = 12 * cfg.width * cfg.height + table_bytes
    c2_bound = bound_ms(c2_bytes, pt_ops(c2_rays, int(scene.sph_count), int(scene.tri_count)))
    log(f"  plain version config 2: {plain_ms:.4f} ms/frame (x{plain_ms / c2_ms:.1f} the "
        f"kernel) [{card}]")
    zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(C2_FRAMES)]
    k4_ms = device_ms(lambda k: pt.render_pt_mega(cfg, scene, zs[k % C2_FRAMES], quat, C2_SPP,
                                                  seed=seed), K4_REPS, "pt_kernel",
                      setup=lambda k: k)
    log(f"  K4 config 2 bound {c2_bound[0]:.5f} ms by {c2_bound[1]} ({c2_bytes} B, "
        f"{pt_ops(c2_rays, int(scene.sph_count), int(scene.tri_count))} ops for {c2_rays} "
        f"rays); K4 {k4_ms:.4f} ms of device time a frame (the profiler's), at "
        f"{c2_bound[0] / k4_ms:.2%} of it [{card}]")
    hd_cfg, hd_scene, _ = hd
    hd_bytes = 12 * hd_cfg.width * hd_cfg.height + table_bytes
    hd_ops = pt_ops(hd_rays, int(hd_scene.sph_count), int(hd_scene.tri_count))
    hd_bound = bound_ms(hd_bytes, hd_ops)
    log(f"  K4 {cfg_size(hd)} {C2_SPP} spp bound {hd_bound[0]:.5f} ms by {hd_bound[1]} "
        f"({hd_bytes} B, {hd_ops} ops for {hd_rays} rays, as the plain version counts them: "
        f"they are K4's bit for bit); the frame at {hd_bound[0] / hd_ms:.2%} of it [{card}]")

    n_c2 = 1 + (C2_ROUNDS + 1) * C2_FRAMES  # warm-up, timed rounds, profiled frames
    want = n_c2 + C4_SPP // C4_CHUNK + 1 + C2_ROUNDS * C2_FRAMES
    log(f"  K4 launches on the main path {launches} (expected {want}: {n_c2} config-2 frames, "
        f"{C4_SPP // C4_CHUNK} config-4 chunks, {1 + C2_ROUNDS * C2_FRAMES} 1080p frames)")
    if launches != want or by_kind["none"] != launches:
        raise AssertionError(f"K4 launches {launches} ({by_kind} by mesh kind) != {want}")
    return {"launches": launches, "ms": k4_ms, "plain_ms": plain_ms,
            "bound_ms": c2_bound[0], "bound_by": c2_bound[1]}


def c3_setup(device):
    """Config 3: (mesh, ClusterSet, scene, cfg, cluster build seconds), as
    benchmarks/run_all.py:120-148 builds it (tri_mats 0, SAH, subtree)."""
    from raytracing_engine_tpu_torch.accel import build_clusters, torus_knot
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    mats_t = np.zeros(mesh.shape[0], np.int32)
    t0 = time.perf_counter()
    cs = build_clusters(mesh, tri_mats=mats_t, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    mats = [
        {"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
        {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
        {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
    ]
    scene = build_pt_scene(spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
                           triangles=mesh, tri_mats=mats_t, materials=mats, device=device)
    return mesh, cs, scene, PTConfig(**C3, rng="pcg"), build_s


def hold_sweep(label, got, want, kernel="K6"):
    """A sweep kernel (K6, K7, K8) against its plain version: -> the max abs
    error of t and attributes where both hit; raises unless every output is
    equal bit for bit."""
    slot_diff = (got[1] != want[1]).double().mean().item()
    both = (got[1] >= 0) & (want[1] >= 0)
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if k != 1 and both.any():
            err = max(err, (g[both] - w[both]).abs().max().item())
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"  {label}: hits {(got[1] >= 0).double().mean().item():.4f}, max_abs_err={err:.6g} "
        f"slots differ on {slot_diff:.6g} of rays, bitwise={bitwise}")
    if not bitwise:
        raise AssertionError(f"{label}: {kernel} differs from its plain version")
    return err


def axis_parallel_rays(device, n=64):
    """An n x n grid against icosphere(2) at (0, 5, 0): axis-parallel rays
    (exact +-0 direction components, some running in a box face's plane)
    and, in the last quarter of the rows, rays parked at 1e18."""
    rng = np.random.default_rng(0)
    center = np.array([0.0, 5.0, 0.0], np.float32)
    o = np.zeros((3, n * n), np.float32)
    d = np.zeros((3, n * n), np.float32)
    for k in range(n * n):
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0
        o[:, k] = center + off
        d[:, k] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    park = slice(3 * n * n // 4, None)
    o[:, park] = 1e18
    d[:, park] = np.float32(0.5773502691896258)
    to = lambda a: tuple(torch.from_numpy(x.reshape(n, n)).to(device) for x in a)  # noqa: E731
    return to(o), to(d)


def c3_rays(c3, quat, seed, device):
    """Config 3's rays at 512x512 (phases 10 and 13): the camera rays of pass
    0, the bounce-1 rays of one K5 pass over the ClusterSet, and the NEE-style
    shadow directions from their origins toward the light sphere's centre
    with their distances: (o0, d0, o1, d1, wi, dist)."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _camera_rays

    _, cs, scene, cfg, _ = c3
    pos = torch.zeros(3, device=device)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = _camera_rays(cfg, pos, quat, u[0], u[1])
    o0, d0 = tuple(x.contiguous() for x in o0), tuple(x.contiguous() for x in d0)
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    state, _ = run(0, None, 0)
    o1 = tuple(state[a].clone() for a in range(3))
    d1 = tuple(state[3 + a].clone() for a in range(3))
    light = torch.tensor(C3_LIGHT, device=device)
    to_l = tuple(light[a] - o1[a] for a in range(3))
    dist = torch.sqrt(to_l[0] * to_l[0] + to_l[1] * to_l[1] + to_l[2] * to_l[2])
    wi = tuple(c / dist for c in to_l)
    return o0, d0, o1, d1, wi, dist


def phase_cluster_kernel(c3, quat, seed, device, card):
    """K6 against its plain version on the card, and K6 timed."""
    from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
    from raytracing_engine_tpu_torch.ops.cuda import cluster
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        k6_bytes,
        sweep_ops,
    )

    mesh, cs, scene, cfg, build_s = c3
    log(f"  config-3 ClusterSet: {mesh.shape[0]} triangles -> {cs.num_clusters} clusters, "
        f"{cs.num_super} super clusters, {cs.padded_tris} slots; BVH builder {cs.builder}; "
        f"host build {build_s:.3f} s")
    pos = torch.zeros(3, device=device)
    fc = cluster.FrameClusters.at(cs, pos)
    orders = dict(order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    o0, d0, o1, d1, wi, dist = c3_rays(c3, quat, seed, device)
    small = build_clusters(icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0)),
                           device=device)
    oa, da = axis_parallel_rays(device)
    inf = float("inf")
    cases = [
        ("camera rays 512x512, closest + attrs", cs, o0, d0, inf, dict(attrs=True, **orders)),
        ("bounce-1 rays, closest + attrs", cs, o1, d1, inf, dict(attrs=True, **orders)),
        ("bounce-1 NEE shadow rays, any hit", cs, o1, wi, dist * 0.999,
         dict(any_hit=True, order=fc.orders[0])),
        (f"axis-parallel + parked rays vs a padded set ({small.num_clusters} clusters, "
         f"{int(torch.isnan(small.boxes[:, 0]).sum())} all-NaN), closest + attrs", small, oa, da,
         inf, dict(attrs=True)),
        ("axis-parallel + parked rays vs the padded set, any hit t_max=2", small, oa, da, 2.0,
         dict(any_hit=True)),
    ]
    err = 0.0
    plain = {}
    for k, (label, cset, o, d, t_max, kw) in enumerate(cases):
        got = cluster.cluster_intersect(cset, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        cluster.work.update(slabs=0, tests=0)
        t0 = time.perf_counter()
        want = cluster.cluster_intersect_reference(cset, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        if k == 0:
            plain = dict(plain_ms=(time.perf_counter() - t0) * 1e3, **cluster.work)
        err = max(err, hold_sweep(label, got, want))

    # K6 alone: the camera sweep of render_pt_fast(bvh=cs) (closest, no attrs)
    kw = dict(cases[0][5], attrs=False)
    cluster.cluster_intersect(cs, o0, d0, inf, **kw)  # warm-up
    ms, host_ms = cuda_ms(lambda k: cluster.cluster_intersect(cs, o0, d0, inf, **kw), K6_REPS)
    tb = cluster.sweep_tables(cs)
    n = cfg.width * cfg.height
    n_bytes = k6_bytes(n, False, cluster_table_bytes(
        [tb.sbox, tb.crec, tb.trec, tb.tsmooth, fc.orders, fc.refs]))
    n_ops = sweep_ops(plain["slabs"], plain["tests"])
    bound = bound_ms(n_bytes, n_ops)
    log(f"  K6 camera sweep 512x512 (closest): kernel {ms:.4f} ms (host enqueue {host_ms:.4f} "
        f"ms), plain {plain['plain_ms']:.1f} ms; {plain['slabs']} box + {plain['tests']} "
        f"triangle tests -> bound {bound[0]:.5f} ms by {bound[1]} ({n_bytes} B, {n_ops} ops), "
        f"kernel at {bound[0] / ms:.2%} of it [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain["plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1]}


# --- the warp sweep's hard rays (phases 11 and 14) ----------------------------

def np_rays(o, d, device):
    """(3, n) numpy origins and directions -> plane tuples on the card."""
    def to(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device) for x in a)

    return to(o), to(d)


def unit(v):
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def vertex_rays(tris, n, rng, reach=0.7):
    """Rays aimed at the shared vertices and edge midpoints of a mesh (T, 3,
    3): each from a point `reach` out on the side of its face's normal, so
    it meets the mesh where two or more triangles meet and rounding decides
    which one holds the hit. -> (o, d), (3, n) each."""
    pick = rng.choice(tris.shape[0], n, replace=tris.shape[0] < n)
    t = tris[pick].astype(np.float64)
    k = rng.integers(0, 3, n)
    a, b = t[np.arange(n), k], t[np.arange(n), (k + 1) % 3]
    target = np.where((np.arange(n) % 2 == 0)[:, None], a, 0.5 * (a + b))
    nrm = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    jitter = rng.normal(0.0, 0.6, (n, 3))
    off = nrm + jitter - np.minimum((jitter * nrm).sum(1, keepdims=True), 0.0) * nrm
    o = target + reach * off / np.linalg.norm(off, axis=1, keepdims=True)
    return o.T.astype(np.float32), unit((target - o).T)


def grazing_rays(boxes, n, rng):
    """Rays that graze boxes (rows [min(3), max(3), ...], NaN rows skipped):
    along a face in its plane, along an edge, through a corner, and nearly
    parallel to a face. -> (o, d), (3, n) each."""
    live = boxes[~np.isnan(boxes[:, 0])][:, :6].astype(np.float32)
    o, d = np.zeros((3, n), np.float32), np.zeros((3, n), np.float32)
    for i in range(n):
        b = live[rng.integers(live.shape[0])]
        mn, mx = b[:3], b[3:]
        mid = 0.5 * (mn + mx)
        kind, ax = i % 4, (i // 4) % 3
        a1, a2 = (ax + 1) % 3, (ax + 2) % 3
        if kind == 0:      # in the plane of the face x_ax = min, along a1
            o[:, i] = mid
            o[ax, i], o[a1, i] = mn[ax], mn[a1] - 0.5
            d[a1, i] = 1.0
        elif kind == 1:    # along the edge x_ax = max, x_a1 = max, along a2
            o[:, i] = mx
            o[a2, i] = mx[a2] + 0.5
            d[a2, i] = -1.0
        elif kind == 2:    # through the min corner
            d[:, i] = unit(rng.uniform(0.2, 1.0, (3, 1)))[:, 0]
            o[:, i] = mn - 0.5 * d[:, i]
        else:              # nearly parallel to the face x_ax = max
            o[:, i] = mid
            o[ax, i], o[a1, i] = mx[ax], mn[a1] - 0.5
            d[a1, i], d[ax, i] = 1.0, (-1e-6 if i % 8 < 4 else 1e-6)
            d[:, i] = unit(d[:, i:i + 1])[:, 0]
    return o, d


def mixed_row_rays(refs, center, n, rng):
    """Rays whose origins sit by the visit-order references in turn (lane j
    by reference j mod K), so the lanes of one warp pick different order
    rows; aimed at `center` with a spread. -> (o, d), (3, n) each."""
    k = np.arange(n) % refs.shape[0]
    o = refs[k].T + rng.normal(0.0, 0.05, (3, n))
    target = center[:, None] + rng.normal(0.0, 1.5, (3, n))
    return o.astype(np.float32), unit(target - o)


def axis_parallel_np(center, n, rng):
    """axis_parallel_rays' pattern around `center` as (3, n) arrays: exact
    +-0 direction components, some in a box face's plane, the last quarter
    parked at 1e18."""
    o, d = np.zeros((3, n), np.float32), np.zeros((3, n), np.float32)
    for k in range(n):
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0
        o[:, k] = center + off
        d[:, k] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    o[:, 3 * n // 4:] = 1e18
    d[:, 3 * n // 4:] = np.float32(0.5773502691896258)
    return o, d


def dup_icosphere():
    """tests/test_torch_cluster.py::test_batched_selection_equals_sequential_scan's
    set: icosphere(1) at (0, 5, 0), every triangle twice, so every hit is an
    exact tie and the first one visited must win."""
    from raytracing_engine_tpu_torch.accel import icosphere

    tris = icosphere(subdivisions=1, radius=1.2, center=(0.0, 5.0, 0.0))
    return np.concatenate([tris, tris])


def dup_scene(device, tris=None):
    """A path-tracing scene of a light sphere, a ground sphere and, given,
    the diffuse triangles `tris` (e.g. dup_icosphere())."""
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, build_pt_scene

    mesh = {} if tris is None else dict(triangles=tris, tri_mats=np.zeros(len(tris), np.int32))
    return build_pt_scene(
        spheres=[((2.5, 7.5, 2.5), 0.6, 1), ((0.0, 5.0, -103.0), 100.0, 2)], device=device,
        materials=[{"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}], **mesh)


def ray_state(o, d):
    """A K5 state of rays (o, d) after a bounce: throughput 1, radiance 0,
    alive, no NEE before, pixel ids 0..n-1 on row 0 (they key the draws);
    a ray whose origin is parked (|o.x| >= 1e17) is a dead one, as a bounce
    leaves it: direction (1, 1, 1)/sqrt(3), throughput 0, not alive."""
    n = o[0].numel()
    st = torch.zeros((17, n), dtype=torch.float32, device=o[0].device)
    for a in range(3):
        st[a], st[3 + a] = o[a], d[a]
    st[6:9] = 1.0
    st[12] = 1.0
    st[15] = torch.arange(n, dtype=torch.float32, device=o[0].device)
    dead = o[0].abs() >= 1e17
    st[3:6, dead] = float(np.float32(0.5773502691896258))
    st[6:9, dead] = 0.0
    st[12, dead] = 0.0
    return st


def same_state(got, want) -> bool:
    """K5's state against its plain version's, bit for bit, except planes
    13-14 (prev_did_nee, prev_pdf) of the rays parked after the bounce: read
    by no later launch, regroup or scatter, zeroed by the kernel's park and
    left by the plain version at what it computed on every lane
    (pathtracer/wavefront.py _bounce)."""
    live = want[0].abs() < 1e17
    return (torch.equal(got[:13], want[:13]) and torch.equal(got[15:], want[15:])
            and torch.equal(got[13:15, live], want[13:15, live]))


def hold_k5_rays(label, scene, bvh, o, d, seed, quat):
    """Bounce 1 of K5 on a state of the rays (o, d) against its plain
    version (the wavefront core on the same state, as
    render_pt_rebin_reference runs it), bit for bit."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed
    from raytracing_engine_tpu_torch.pathtracer import PTConfig
    from raytracing_engine_tpu_torch.pathtracer.wavefront import (
        STATE_PLANES,
        _trace_core,
        pack_state,
        unpack_state,
    )

    n = o[0].numel()
    cfg = PTConfig(width=n, height=1, max_bounces=2, rng="pcg")
    pos = torch.zeros(3, device=o[0].device)
    state = ray_state(o, d)
    t0 = time.perf_counter()
    st = _trace_core(cfg, pt.kernel_scene(scene, bvh), pos, quat, pass_seed(seed, 0),
                     state_in=unpack_state(state), bvh=pt.frame_view(bvh, pos), bounce_lo=1,
                     bounce_hi=1, emit_state=True)
    want, n_want = pack_state(st).reshape(STATE_PLANES, n), int(st["nrays"])
    plain_s = time.perf_counter() - t0
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, bvh)
    got, n_got = run(1, state.clone(), 0)
    torch.cuda.synchronize()
    same = same_state(got, want) and int(n_got) == n_want
    live = int((state[0].abs() < 1e17).sum())
    log(f"  K5 {label}: {n} rays ({live} live, last warp {n % 32 or 32} lanes), bounce 1 vs "
        f"its plain version bit for bit (the state; planes 13-14 of the "
        f"{int((want[0].abs() >= 1e17).sum())} rays it parks aside): {same}; rays "
        f"{n_want}, alive after it {(want[12] > 0).double().mean().item():.3f}; plain "
        f"{plain_s:.1f} s")
    if not same:
        raise AssertionError(f"K5 {label}: differs from its plain version")


def hold_k7_rays(label, inst_tab, cs, o, d, origin):
    """K7 against its plain version on the rays (o, d), closest hit with
    normals and any hit (t_max 2.5), bit for bit; -> the max abs error."""
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst

    err = 0.0
    n = o[0].numel()
    for what, mode in (("closest + normal", dict(attrs=True)),
                       ("any hit", dict(any_hit=True, t_max=2.5))):
        want = kinst.instanced_cluster_intersect_reference(inst_tab, cs, o, d, origin=origin,
                                                           **mode)
        got = kinst.instanced_cluster_intersect(inst_tab, cs, o, d, origin=origin, **mode)
        torch.cuda.synchronize()
        err = max(err, hold_sweep(f"K7 {label}, {n} rays (last warp {n % 32 or 32} lanes), "
                                  f"{what}", got, want, "K7"))
    return err


def instance_world(inst_tab, pts):
    """(P, 3) object-space points -> (N, P, 3) world points of every instance
    of a pack_instances table: R (s p) + trans, R = inv_rot^T."""
    tab = inst_tab.cpu().numpy().astype(np.float64)
    inv = tab[:, 0:9].reshape(-1, 3, 3)
    return (np.einsum("nji,pj->npi", inv, pts.astype(np.float64)) * tab[:, None, 12:13]
            + tab[:, None, 9:12])


def phase_c3_warp_rays(c3, quat, seed, device):
    """K5's warp sweep (phase 11) on the rays where it can break, config 3's
    set and the duplicated icosphere, against its plain version bit for
    bit."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster

    mesh, cs, scene, _, _ = c3
    from raytracing_engine_tpu_torch.accel import build_clusters

    rng = np.random.default_rng(7)
    tris = dup_icosphere()
    dscene = dup_scene(device, tris)
    dcs = build_clusters(tris, tri_mats=np.zeros(len(tris), np.int32), device=device)
    refs = cluster.FrameClusters.at(cs, torch.zeros(3, device=device)).refs.cpu().numpy()
    knot_center = np.array([0.0, 8.0, 0.0], np.float32)
    sets = [
        ("config 3, knot vertices and edge midpoints", scene, cs,
         vertex_rays(mesh, 32 * 40 + 13, rng)),
        ("config 3, grazing cluster boxes", scene, cs,
         grazing_rays(cs.boxes.cpu().numpy(), 32 * 24 + 7, rng)),
        (f"config 3, lanes by the {refs.shape[0]} order references in turn (mixed rows)", scene,
         cs, mixed_row_rays(refs, knot_center, 32 * 24 + 19, rng)),
        ("duplicated icosphere (every hit a tie), vertices and edges", dscene, dcs,
         vertex_rays(dup_icosphere(), 32 * 12 + 5, rng)),
        ("duplicated icosphere, axis-parallel and parked", dscene, dcs,
         axis_parallel_np(np.array([0.0, 5.0, 0.0], np.float32), 32 * 12 + 1, rng)),
    ]
    for label, sc, cset, (o, d) in sets:
        hold_k5_rays(label, sc, cset, *np_rays(o, d, device), seed, quat)


def phase_c5_warp_rays(c5, quat, seed, device):
    """K7's and K5's warp sweeps with instances (phase 14) on the rays where
    they can break, against their plain versions bit for bit; -> K7's max
    error."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        make_instanced_clusters,
        make_instances,
    )

    rng = np.random.default_rng(11)
    cs, ic, mesh = c5["cs"], c5["ic"], c5["mesh"]
    # the duplicated icosphere as two instances, one rotated and scaled
    dup = dup_icosphere() - np.array([0.0, 5.0, 0.0], np.float32)
    rot = np.array([[np.cos(0.7), -np.sin(0.7), 0.0], [np.sin(0.7), np.cos(0.7), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pair = make_instances(build_bvh(dup, device=device),
                          [(np.eye(3, dtype=np.float32), (0.0, 5.0, 0.0), 1.0),
                           (rot, (1.4, 5.4, 0.3), 0.8)], device=device)
    dcs = build_clusters(dup, device=device)
    dic = make_instanced_clusters(pair, dcs, device=device)
    # world vertices of a few config-5 instances, and of both duplicates
    pick = rng.choice(mesh.shape[0], 256, replace=False)
    world = instance_world(ic.inst_tab, mesh[pick].reshape(-1, 3)).reshape(-1, 256, 3, 3)
    knot_w = world[rng.integers(0, world.shape[0], 256), np.arange(256)]  # one instance each
    dup_w = instance_world(dic.inst_tab, dup.reshape(-1, 3)).reshape(-1, 3, 3)
    err = 0.0
    for label, tab, cset, (o, d) in (
            ("config 5, instance-space knot vertices and edges in the world", ic.inst_tab, cs,
             vertex_rays(knot_w, 32 * 20 + 9, rng)),
            ("config 5, grazing the instances' world boxes", ic.inst_tab, cs,
             grazing_rays(ic.inst_tab[:, 13:19].cpu().numpy(), 32 * 8 + 3, rng)),
            ("two instances of the duplicated icosphere (ties), vertices and edges",
             dic.inst_tab, dcs, vertex_rays(dup_w, 32 * 12 + 17, rng)),
            ("two instances of the duplicated icosphere, axis-parallel and parked",
             dic.inst_tab, dcs, axis_parallel_np(np.array([0.0, 5.0, 0.0], np.float32),
                                                 32 * 12 + 1, rng))):
        err = max(err, hold_k7_rays(label, tab, cset, *np_rays(o, d, device),
                                    origin=torch.zeros(3, device=device)))
    # K5 with instances: config 5's cell and the duplicates as a scene
    dscene = dup_scene(device)
    dic_pt = make_instanced_clusters(pair, dcs, scene=dscene, device=device)
    hold_k5_rays("config 5, knot vertices and edges of the instances", c5["scene"], ic,
                 *np_rays(*vertex_rays(knot_w, 32 * 10 + 21, rng), device), seed, quat)
    hold_k5_rays("two instances of the duplicated icosphere (ties)", dscene, dic_pt,
                 *np_rays(*vertex_rays(dup_w, 32 * 8 + 3, rng), device), seed, quat)
    return err


def phase_c3_invariants(c3, quat, seed, device):
    """The config-3 path through K4, K5 and K6 against the plain versions
    and each other; -> the plain times, K5's error and the sweep work of
    the frame (for K5's bound), K4's frame numbers but its time."""
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    _, cs, scene, cfg, _ = c3
    pos = torch.zeros(3, device=device)
    k5, n5 = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    k4, n4 = pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    same = torch.equal(k5, k4) and int(n5) == int(n4)
    log(f"  render_pt_rebin (none,morton) == render_pt_mega(bvh=cs) bit for bit: {same}; "
        f"rays {int(n5)} == {int(n4)}; lit pixels {(k4.amax(-1) > 0).double().mean().item():.4f}")
    if not same:
        raise AssertionError("K5 differs from K4 with clusters")
    for mode in ("none", "oct", "morton", "oct_morton", "tile_oct"):
        img, n = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed, bvh=cs, rebin=mode)
        if not (torch.equal(img, k4) and int(n) == int(n4)):
            raise AssertionError(f"rebin={mode!r} differs from K4")
    log("  every regroup mode (none, oct, morton, oct_morton, tile_oct) == K4 bit for bit")

    cluster.work.update(slabs=0, tests=0)
    t0 = time.perf_counter()
    pr, prn = pt.render_pt_rebin_reference(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    torch.cuda.synchronize(device)
    plain_rebin_ms = (time.perf_counter() - t0) * 1e3
    work = dict(cluster.work)
    err = hold_pt("K5 (render_pt_rebin) vs its plain version 512x512", k5, n5, pr, prn)
    log(f"  plain version 512x512: render_pt_rebin_reference {plain_rebin_ms:.1f} ms; sweep "
        f"work of the frame {work['slabs']} box + {work['tests']} triangle tests")

    # bands of both kernels bit for bit the rows of the full render
    row0, band_h = C3_BAND
    band = dict(seed=seed, bvh=cs, row0=row0, band_h=band_h)
    b5, _ = pt.render_pt_rebin(cfg, scene, pos, quat, 1, **band)
    b4, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, **band)
    rows = k4[row0:row0 + band_h]
    log(f"  band rows {row0}..{row0 + band_h}: K5 == full render rows {torch.equal(b5, rows)}, "
        f"K4 == full render rows {torch.equal(b4, rows)}")
    if not (torch.equal(b5, rows) and torch.equal(b4, rows)):
        raise AssertionError("a config-3 band differs from the rows of the full render")
    # K4 against its plain version on the whole frame, the band's rows
    # included; the replay counts the work of K4's least time
    k4_frame = hold_k4_frame("config 3", cfg, scene, cs, pos, quat, seed, k4, n4, device)

    f, nf = render_pt_fast(cfg, scene, pos, quat, 1, seed=seed, bvh=cs)
    hold_pt("render_pt_fast(bvh=cs) through K6 vs K4", f, nf, k4, n4)

    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    for state in progressive_render(cfg, scene, state, 4, passes_per_chunk=2, bvh=cs,
                                    render_fn=pt.render_pt_mega):
        pass
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 4, seed=seed, bvh=cs)
    want = one * 4.0
    ok = torch.allclose(state.accum, want, rtol=C3_CHUNK_RTOL, atol=1e-6)
    log(f"  progressive_render(bvh=cs) 2 x 2 spp vs one 4-spp render (sums): max_abs_err="
        f"{(state.accum - want).abs().max().item():.6g} within rtol {C3_CHUNK_RTOL:.3g}: {ok}")
    if state.spp_done != 4 or not ok:
        raise AssertionError("progressive_render(bvh=cs) depends on the chunking")
    ragged = hold_k4_ragged("config 3", cfg, scene, cs, pos, quat, seed, C3_BAND[0], RAGGED_ROWS)
    k4_frame["max_abs_err"] = max(k4_frame["max_abs_err"], ragged)
    return {"max_abs_err": err, "plain_rebin_ms": plain_rebin_ms, "work": work,
            "nrays": int(n4), "k4": k4_frame}


def profile_rebin(cfg, scene, cs, quat, seed, zs, frame_ms, card):
    """torch.profiler over C3_FRAMES render_pt_rebin frames: device time of
    K5 per bounce, of the sort, the permute and the un-permute, and of the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops.cuda import pt

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=cs), C3_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        log("  profiler: no device events; the split is not measured")
        return
    nb = cfg.max_bounces + 1
    k5 = [e.time_range.elapsed_us() for e in events if "pt_rebin_kernel" in e.name]
    per_bounce = [sum(k5[b::nb]) / C3_FRAMES for b in range(nb)]
    ops = {e.key: e for e in prof.key_averages()}

    def op_us(key):
        """Device time of the kernels that aten op `key` launched, per frame."""
        e = ops.get(key)
        if e is None:
            return 0.0
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / C3_FRAMES

    split = {"sort": op_us("aten::sort"), "permute (index_select)": op_us("aten::index_select"),
             "un-permute (index_copy_)": op_us("aten::index_copy_")}
    busy = sum(e.time_range.elapsed_us() for e in events) / C3_FRAMES
    rest = busy - sum(per_bounce) - sum(split.values())
    log(f"  profile render_pt_rebin {cfg.width}x{cfg.height} ({C3_FRAMES} frames, profiler on: "
        f"{prof_ms:.4f} ms/frame): device busy {busy:.1f} us/frame = "
        f"{busy / 1e3 / frame_ms:.1%} of the unprofiled {frame_ms:.4f} ms frame; K5 by bounce "
        f"{[round(x, 1) for x in per_bounce]} us; "
        + ", ".join(f"{k} {v:.1f} us" for k, v in split.items())
        + f"; everything else (keys, bounding box, counters) {rest:.1f} us [{card}]")


def phase_c3_main(c3, quat, seed, device, card, inv):
    """Config 3's entry points under the launch counters, timed."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        k5_bytes,
        pt_ops,
        sweep_ops,
    )

    _, cs, scene, cfg, _ = c3
    hd = dataclasses.replace(cfg, **C3_HD)

    def frames(c, fn, n_frames, label):
        zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(n_frames)]
        fn(c, scene, zs[0], quat, 1, seed=seed, bvh=cs)  # warm-up
        best = None
        for r in range(C3_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(
                fn(c, scene, zs[k], quat, 1, seed=seed, bvh=cs)[1]), n_frames)
            n = int(torch.stack(rays).sum()) // n_frames
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms) "
                f"= {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame [{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best, zs

    reset_k4()
    pt.rebin_launches = cluster.launches = 0
    (c3_ms, c3_rays), zs = frames(cfg, pt.render_pt_rebin, C3_FRAMES,
                                  f"config 3 render_pt_rebin {cfg.width}x{cfg.height}")
    profile_rebin(cfg, scene, cs, quat, seed, zs, c3_ms, card)
    (hd_ms, hd_rays), _ = frames(hd, pt.render_pt_rebin, C3_HD_FRAMES,
                                 f"config 3 render_pt_rebin {hd.width}x{hd.height}")
    (mega_ms, _), _ = frames(cfg, pt.render_pt_mega, C3_FRAMES,
                             f"config 3 render_pt_mega(bvh=cs) {cfg.width}x{cfg.height}")
    pos = torch.zeros(3, device=device)
    fast_ms, _ = cuda_ms(lambda k: render_pt_fast(cfg, scene, pos, quat, 1, seed=seed, bvh=cs), 1)
    state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
    for state in progressive_render(cfg, scene, state, 2, passes_per_chunk=1, bvh=cs,
                                    render_fn=pt.render_pt_mega):
        pass
    torch.cuda.synchronize(device)
    counts = {"K4": pt.launches, "K5": pt.rebin_launches, "K6": cluster.launches}
    k4_clusters = pt.mesh_launches["clusters"]
    nb = cfg.max_bounces + 1
    rebin_frames = (1 + C3_ROUNDS * C3_FRAMES + C3_FRAMES) + (1 + C3_ROUNDS * C3_HD_FRAMES)
    want = {"K4": 1 + C3_ROUNDS * C3_FRAMES + 2, "K5": nb * rebin_frames, "K6": 2 * nb}
    log(f"  render_pt_fast(bvh=cs) {cfg.width}x{cfg.height}: {fast_ms:.2f} ms (K6 sweeps + the "
        f"plain wavefront around them) [{card}]")
    log(f"  launches on the config-3 main path {counts} (expected {want}: {nb} K5 per rebin frame "
        f"x {rebin_frames}, K4 per mega frame and progressive chunk, 2 K6 per bounce of the "
        f"render_pt_fast frame)")
    if counts != want or k4_clusters != counts["K4"]:
        raise AssertionError(f"config-3 launch counts {counts} (K4 with clusters {k4_clusters}) "
                             f"!= {want}")

    # K5 alone, bounce by bounce, on the states of the phase-11 frame: the
    # profiler's device time per launch
    k5_ms = k5_bounce_ms(cfg, scene, cs, pos, quat, seed)
    fc = cluster.FrameClusters.at(cs, pos)
    tb = cluster.sweep_tables(cs)
    tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, fc.orders, fc.refs])
    tables += 4 * sum(t.numel() for t in pt.pack_pt_scene(pt.kernel_scene(scene, cs)))
    n = cfg.width * cfg.height
    ops = sweep_ops(inv["work"]["slabs"], inv["work"]["tests"]) + pt_ops(
        inv["nrays"], int(scene.sph_count), 0)
    k5_bound = bound_ms(k5_bytes(n, cfg.max_bounces, tables), ops)
    k4 = inv["k4"]
    # K4 on the frame whose plain replay gave its bound (zs[0] == pos)
    k4_ms = device_ms(lambda _: pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed, bvh=cs),
                      K4_REPS, "pt_kernel")
    log(f"  K5 alone per bounce (device time) {[round(x, 4) for x in k5_ms]} ms = "
        f"{sum(k5_ms):.4f} ms/frame; "
        f"bound {k5_bound[0]:.5f} ms by {k5_bound[1]} ({ops} ops: sweeps + "
        f"{int(scene.sph_count)} spheres x {inv['nrays']} rays); K5 at "
        f"{k5_bound[0] / sum(k5_ms):.2%} of it [{card}]")
    log(f"  config 3 512x512: rebin {c3_ms:.4f} ms/frame = {c3_rays / c3_ms / 1e3:.2f} Mrays/s; "
        f"mega {mega_ms:.4f} ms/frame; 1920x1088 rebin {hd_ms:.4f} ms/frame = "
        f"{hd_rays / hd_ms / 1e3:.2f} Mrays/s; K4 config-3 frame bound {k4['bound_ms']:.5f} ms "
        f"by {k4['bound_by']}; K4 {k4_ms:.4f} ms of device time a frame (the profiler's), at "
        f"{k4['bound_ms'] / k4_ms:.2%} of it [{card}]")
    return {"launches": counts, "k5": {"ms": sum(k5_ms), "plain_ms": inv["plain_rebin_ms"],
                                       "bound_ms": k5_bound[0], "bound_by": k5_bound[1]},
            "k4": {**k4, "ms": k4_ms}}


def device_ms(launch, reps: int, name: str, setup=lambda k: None) -> float:
    """Median device time (ms) of kernel `name` over reps calls of
    launch(setup(k)), setup's work (a fresh input) made before each call:
    by torch.profiler, after one call outside it. Where three profiled runs
    record no device event (it happens now and then), each call is timed by
    CUDA events instead, enqueued behind a spin kernel so that the events
    bracket the kernel and not the host's enqueue. Raises unless the time is
    finite and positive."""
    from torch.profiler import ProfilerActivity, profile

    launch(setup(reps))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(reps):
                launch(setup(k))
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if us:
            ms = sorted(us)[len(us) // 2] / 1e3
            break
    else:
        times = []
        for k in range(reps):
            x = setup(k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            launch(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        log(f"  {name}: the profiler recorded no device event in 3 runs; CUDA events behind a "
            f"spin kernel: {ms:.4f} ms")
    if not (math.isfinite(ms) and ms > 0.0):
        raise AssertionError(f"{name}: no device time measured ({ms})")
    return ms


def k5_bounce_ms(cfg, scene, bvh, pos, quat, seed) -> list:
    """K5's device time per bounce on the states of one frame (render_pt_rebin's
    default regroup between bounces); each timed launch gets a fresh copy of
    its bounce's state (K5 updates the state in place)."""
    from raytracing_engine_tpu_torch.ops.cuda import pt

    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, bvh)
    modes = pt._gap_modes("none,morton")
    inputs = [None]
    st, _ = run(0, None, 0)
    for b in range(1, cfg.max_bounces + 1):
        st = pt.regroup(st, modes[min(b - 1, len(modes) - 1)])
        inputs.append(st.clone())
        st, _ = run(b, st, 0)
    return [device_ms(lambda y, b=b: run(b, y, 0), 9, "pt_rebin_kernel",
                      setup=lambda k, x=x: None if x is None else x.clone())
            for b, x in enumerate(inputs)]


def phase_bvh_kernel(c3, quat, seed, device, card):
    """K8 against its plain version on config 3's mesh as a raw BVH and on
    the rays where a walk can break (ties, cut walks, ragged counts), bit
    for bit; K8 timed on the camera, bounce-1 and shadow rays, beside K6 on
    the camera rays; -> (K8's results, the BVH)."""
    from raytracing_engine_tpu_torch.accel import build_bvh, icosphere
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
    from raytracing_engine_tpu_torch.ops.cuda import cluster
    from raytracing_engine_tpu_torch.pathtracer.wavefront import BVH_MAX_STEPS
    from raytracing_engine_tpu_torch.utils.timing import bound_ms, bvh_ops, k8_bytes

    mesh, cs, _, cfg, _ = c3
    t0 = time.perf_counter()
    bvh = build_bvh(mesh, device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    tables = kbvh.tables_of(bvh)
    n_nodes, n_tris = bvh.bb_min.shape[0], bvh.v0.shape[0]
    log(f"  config-3 raw BVH: {n_nodes} nodes over {n_tris} triangles, builder {bvh.builder}, "
        f"host build {build_s:.3f} s")
    o0, d0, o1, d1, wi, dist = c3_rays(c3, quat, seed, device)
    small = kbvh.tables_of(build_bvh(icosphere(subdivisions=2, radius=1.2,
                                               center=(0.0, 5.0, 0.0)), device=device))
    dup = kbvh.tables_of(build_bvh(dup_icosphere(), device=device))
    oa, da = axis_parallel_rays(device)
    rng = np.random.default_rng(11)
    ov, dv = np_rays(*vertex_rays(dup_icosphere(), 32 * 12 + 5, rng), device)
    # ragged counts through the middle of the image, where the knot is
    mid = cfg.height // 2
    o_rag, d_rag = (tuple(p[mid - 6:mid + 7, 1:510] for p in x) for x in (o0, d0))
    o_row, d_row = (tuple(p[mid, :].reshape(-1)[5:] for p in x) for x in (o0, d0))
    inf = float("inf")
    steps = dict(max_steps=BVH_MAX_STEPS)  # the wavefront's cap
    size = f"{cfg.width}x{cfg.height}"
    cases = [
        (f"camera rays {size}, closest", tables, o0, d0, inf, {}),
        ("bounce-1 rays, closest", tables, o1, d1, inf, {}),
        ("bounce-1 NEE shadow rays, any hit", tables, o1, wi, dist * 0.999, dict(any_hit=True)),
        ("axis-parallel + parked rays vs icosphere(2), closest", small, oa, da, inf, {}),
        ("axis-parallel + parked rays vs icosphere(2), any hit t_max=2", small, oa, da, 2.0,
         dict(any_hit=True)),
        ("duplicated icosphere (every hit a tie), vertices and edges, closest", dup, ov, dv,
         inf, {}),
        ("duplicated icosphere, vertices and edges, any hit", dup, ov, dv, inf,
         dict(any_hit=True)),
        (f"duplicated icosphere, walks cut at max_steps={K8_CUT_STEPS[0]}", dup, ov, dv, inf,
         dict(max_steps=K8_CUT_STEPS[0])),
        (f"camera rays {size}, walks cut at max_steps={K8_CUT_STEPS[1]}", tables, o0, d0, inf,
         dict(max_steps=K8_CUT_STEPS[1])),
        (f"camera rays, a 13 x 509 band of the middle rows ({13 * 509} rays: ragged blocks "
         "and warps)", tables, o_rag, d_rag, inf, {}),
        (f"camera rays, {cfg.width - 5} of the middle row in a flat list (a ragged last warp)",
         tables, o_row, d_row, inf, {}),
    ]
    err, plain = 0.0, {}
    for k, (label, tb, o, d, t_max, kw) in enumerate(cases):
        kw = {**steps, **kw}
        got = kbvh.bvh_intersect_packet(tb, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        kbvh.work.update(nodes=0, tests=0)
        t0 = time.perf_counter()
        want = kbvh.bvh_intersect_packet_reference(tb, o, d, t_max, **kw)
        torch.cuda.synchronize(device)
        if k < 3:
            plain[k] = dict(plain_ms=(time.perf_counter() - t0) * 1e3, **kbvh.work)
        err = max(err, hold_sweep(f"K8 {label}", got, want, "K8"))

    # K8 alone on the camera, bounce-1 and shadow rays (the profiler's device
    # time: a K8 launch takes about as long as its wrapper's host work), and
    # K6 on the camera rays and the same mesh
    fc = cluster.FrameClusters.at(cs, torch.zeros(3, device=device))
    k6kw = dict(order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    n = cfg.width * cfg.height
    rows = []
    for k, label in enumerate(("camera rays", "bounce-1 rays", "shadow rays")):
        _, tb, o, d, t_max, kw = cases[k]
        ms = device_ms(lambda _, o=o, d=d, t_max=t_max, kw=kw: kbvh.bvh_intersect_packet(
            tb, o, d, t_max, **kw, **steps), K8_REPS, "traverse_kernel")
        n_bytes = k8_bytes(n, n_nodes, n_tris, tmax_plane=k == 2)
        n_ops = bvh_ops(plain[k]["nodes"], plain[k]["tests"])
        bound = bound_ms(n_bytes, n_ops)
        rows.append(dict(ms=ms, plain_ms=plain[k]["plain_ms"], bound_ms=bound[0],
                         bound_by=bound[1]))
        log(f"  K8 {label} {size}: {ms:.4f} ms (device time by the profiler, median of "
            f"{K8_REPS}); plain {plain[k]['plain_ms']:.1f} ms; {plain[k]['nodes']} node + "
            f"{plain[k]['tests']} triangle tests -> bound {bound[0]:.5f} ms by {bound[1]} "
            f"({n_bytes} B, {n_ops} ops), kernel at {bound[0] / ms:.2%} of it [{card}]")
    k6_ms = device_ms(lambda _: cluster.cluster_intersect(cs, o0, d0, inf, **k6kw), K8_REPS,
                      "cluster_kernel")
    log(f"  K8 summed over the three ray sets {sum(r['ms'] for r in rows):.4f} ms; K6 on the "
        f"camera rays and the same mesh {k6_ms:.4f} ms (K8 at {k6_ms / rows[0]['ms']:.2f}x its "
        f"speed) [{card}]")
    return {"max_abs_err": err, **rows[0]}, bvh


def c5_setup(device):
    """Config 5 as benchmarks/run_all.py:338-345 and :456-471 build it: the
    knot, its BVH and ClusterSet (no triangle materials), the 30 instances,
    the Phong cells' albedos and light, and the path-traced cell's scene and
    InstancedClusters."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        make_instanced_clusters,
        torus_knot,
    )
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    mesh = torus_knot(**C5_KNOT)
    t0 = time.perf_counter()
    bvh = build_bvh(mesh, device=device)
    cs = build_clusters(mesh, device=device)
    inst = grid_instances(bvh, **C5_GRID, mats=np.arange(30, dtype=np.int32) % 3,
                          device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    scene = build_pt_scene(
        spheres=[((8.0, 2.0, 10.0), 2.0, 3), ((0.0, 14.0, -103.0), 100.0, 4)],
        materials=[{"albedo": (0.75, 0.5, 0.3), "kind": DIFFUSE},
                   {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (40.0, 38.0, 34.0), "kind": DIFFUSE},
                   {"albedo": (0.55, 0.55, 0.5), "kind": DIFFUSE}], device=device)
    ic = make_instanced_clusters(inst, cs, scene=scene, device=device)
    return dict(mesh=mesh, bvh=bvh, cs=cs, inst=inst, ic=ic, scene=scene, build_s=build_s,
                albedo=torch.tensor(C5_ALBEDO, device=device),
                light=torch.tensor(C5_LIGHT, device=device), cam=torch.zeros(3, device=device),
                cfg=PTConfig(**C5_PT, rng="pcg"))


def instances_hit(code, t_pad: int, n_inst: int) -> int:
    """How many distinct instances the hit codes of a plane name."""
    inst = code[code >= 0] // t_pad
    return int(torch.bincount(inst.long(), minlength=n_inst).gt(0).sum())


def busiest_rows(code, t_pad: int, n_inst: int, bh: int) -> tuple[int, int]:
    """(row0, instances): the first run of bh rows whose hit codes name the
    most distinct instances, and how many they name."""
    h = code.shape[0]
    inst = torch.where(code >= 0, code // t_pad + 1, 0).long()
    rows = torch.zeros(h, n_inst + 1, device=code.device).scatter_(1, inst, 1.0)[:, 1:]
    cover = rows.unfold(0, bh, 1).amax(-1).gt(0).sum(1)
    row0 = int(torch.argmax(cover))
    return row0, int(cover[row0])


def phase_instanced_kernel(c5, quat, seed, device):
    """K7 and the instanced paths against their plain versions on the card;
    -> (K7's max error, K4<instances>'s frame numbers but its time)."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        icosphere,
        make_instanced_clusters,
        make_instances,
    )
    from raytracing_engine_tpu_torch.models.instanced import (
        camera_rays,
        render_instanced_phong,
        render_instanced_phong_reference,
        shadow_rays,
    )
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _camera_rays, render_pt_fast

    cs, ic, cam, cfg, scene = c5["cs"], c5["ic"], c5["cam"], c5["cfg"], c5["scene"]
    log(f"  config 5: {ic.num_instances} instances x {c5['mesh'].shape[0]} triangles = "
        f"{c5['inst'].total_triangles} triangles; base set {cs.num_clusters} clusters, "
        f"{cs.num_super} super clusters, {cs.padded_tris} slots; host build {c5['build_s']:.3f} s")

    def held(label, tab, cset, o, d, **kw):
        got = kinst.instanced_cluster_intersect(tab, cset, o, d, **kw)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        want = kinst.instanced_cluster_intersect_reference(tab, cset, o, d, **kw)
        torch.cuda.synchronize(device)
        err = hold_sweep(f"K7 {label} (plain {time.perf_counter() - t0:.1f} s)", got, want, "K7")
        return err, got

    # reduced: 2 x 2 instances of the knot at the path tracer's 512x512
    inst4 = grid_instances(c5["bvh"], nx=2, ny=2, spacing=4.0, base=(0.0, 14.0, 0.0),
                           mats=[0, 1, 2, 0], device=device)
    ic4 = make_instanced_clusters(inst4, cs, device=device)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = _camera_rays(cfg, cam, quat, u[0], u[1])
    o0, d0 = tuple(x.contiguous() for x in o0), tuple(x.contiguous() for x in d0)
    errs = []
    e, got = held(f"2x2 instances, camera rays {cfg.width}x{cfg.height}, closest + normal",
                  ic4.inst_tab, cs, o0, d0, attrs=True, origin=cam)
    errs.append(e)
    so, sd, tm = shadow_rays(o0, d0, got, c5["light"])
    errs.append(held("2x2 instances, render_instanced_phong's shadow rays from those hits "
                     "(misses and back faces parked), any hit", ic4.inst_tab, cs, so, sd,
                     any_hit=True, t_max=tm, origin=cam)[0])
    ico = icosphere(subdivisions=2, radius=1.0)
    rot = np.array([[np.cos(0.7), -np.sin(0.7), 0.0], [np.sin(0.7), np.cos(0.7), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pair = make_instances(build_bvh(ico, device=device),
                          [(np.eye(3, dtype=np.float32), (0.0, 5.0, 0.0), 1.2),
                           (rot, (0.6, 5.4, 0.3), 0.8)], device=device)
    icp = make_instanced_clusters(pair, build_clusters(ico, device=device), device=device)
    oa, da = axis_parallel_rays(device)
    errs.append(held("axis-parallel + parked rays vs 2 scaled instances, closest + normal",
                     icp.inst_tab, icp.cs, oa, da, attrs=True)[0])
    errs.append(held("axis-parallel + parked rays vs 2 scaled instances, any hit t_max=2",
                     icp.inst_tab, icp.cs, oa, da, any_hit=True, t_max=2.0)[0])

    # the full config 5: render_instanced_phong through K7 against its plain
    # version on a band (its K7 closest and any-hit launches on the path's own
    # rays; the whole frame's camera rays are held in phase 15, where their
    # replay gives K7's bound), and bands
    n_inst, t_pad = ic.num_instances, cs.padded_tris
    width, height = C5_SIZE
    row0, bh = C5_BAND
    ob, db = camera_rays(cam, 0.0, width, height, row0=row0, band_h=bh)
    band_code = kinst.instanced_cluster_intersect(ic.inst_tab, cs, ob, db, origin=cam)[1]
    log(f"  Phong rows {row0}..{row0 + bh}: the camera rays hit "
        f"{instances_hit(band_code, t_pad, n_inst)} of the {n_inst} instances")
    args = (ic.inst_tab, cs, c5["inst"].mat, c5["albedo"], cam, 0.0, c5["light"])
    band = dict(row0=row0, band_h=bh)
    for label, kw in (("hard shadows", {}), (f"soft shadows {C5_SOFT}", C5_SOFT)):
        full = render_instanced_phong(*args, **kw)
        got = render_instanced_phong(*args, **kw, **band)
        t0 = time.perf_counter()
        want = render_instanced_phong_reference(*args, **kw, **band)
        torch.cuda.synchronize(device)
        plain_s = time.perf_counter() - t0
        same, rows = torch.equal(got, want), torch.equal(got, full[row0:row0 + bh])
        log(f"  render_instanced_phong {width}x{height}, {label}: rows {row0}..{row0 + bh} "
            f"through K7 == plain version bit for bit: {same} (plain {plain_s:.1f} s); band == "
            f"rows of the full frame: {rows}; lit pixels "
            f"{(full.amax(-1) > 0).double().mean().item():.4f}, finite "
            f"{bool(torch.isfinite(full).all())}")
        if not (same and rows and torch.isfinite(full).all()):
            raise AssertionError(f"render_instanced_phong ({label}) differs from its plain "
                                 "version or from the full frame")

    # the path-traced cell: K5 == K4, both against their plain versions
    k4, n4 = pt.render_pt_mega(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    for mode in ("none,morton", "none", "oct", "morton", "oct_morton", "tile_oct"):
        img, n = pt.render_pt_rebin(cfg, scene, cam, quat, 1, seed=seed, bvh=ic, rebin=mode)
        if not (torch.equal(img, k4) and int(n) == int(n4)):
            raise AssertionError(f"config 5: rebin={mode!r} differs from K4")
    log(f"  config 5 PT {cfg.width}x{cfg.height}: render_pt_rebin == render_pt_mega(bvh=ic) bit "
        f"for bit in every regroup mode (none,morton, none, oct, morton, oct_morton, tile_oct); "
        f"rays {int(n4)}; lit pixels {(k4.amax(-1) > 0).double().mean().item():.4f}")
    # K4 and K5 on the band of rows whose camera rays hit the most instances,
    # bit for bit the rows of the full render; K5 against its plain version
    # there, K4 against its own on the whole frame (its replay counts the
    # work of K4's least time)
    cam_code = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o0, d0, origin=cam)[1]
    row0, covered = busiest_rows(cam_code, t_pad, n_inst, C5_PT_BAND_H)
    bh = C5_PT_BAND_H
    rows = f"rows {row0}..{row0 + bh} (their camera rays hit {covered} of the {n_inst} instances)"
    kw = dict(seed=seed, bvh=ic, row0=row0, band_h=bh)
    b4, _ = pt.render_pt_mega(cfg, scene, cam, quat, 1, **kw)
    band, nband = pt.render_pt_rebin(cfg, scene, cam, quat, 1, **kw)
    if not (torch.equal(b4, k4[row0:row0 + bh]) and torch.equal(band, k4[row0:row0 + bh])):
        raise AssertionError("a config-5 K4 or K5 band differs from the rows of the full render")
    t0 = time.perf_counter()
    want, nwant = pt.render_pt_rebin_reference(cfg, scene, cam, quat, 1, **kw)
    torch.cuda.synchronize(device)
    hold_pt(f"K5 with {n_inst} instances vs its plain version, {rows} (plain "
            f"{time.perf_counter() - t0:.1f} s; K4's and K5's bands == full-frame rows)", band,
            nband, want, nwant)
    k4_frame = hold_k4_frame("config 5 PT", cfg, scene, ic, cam, quat, seed, k4, n4, device)
    f, nf = render_pt_fast(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    hold_pt("render_pt_fast(bvh=ic) through K7 vs K4", f, nf, k4, n4)
    # K4 with instances on the ragged band, through the two scaled icosphere
    # instances (config 5's lights and materials): the plain two-level sweep
    # costs seconds per call, instance and super cluster (61.6 s for 3 rows
    # of the 30 knots at 3 spp, 27.7 s for 5 rows of 2 x 2 knots)
    code = kinst.instanced_cluster_intersect(icp.inst_tab, icp.cs, o0, d0, origin=cam)[1]
    row0, _ = busiest_rows(code, icp.cs.padded_tris, icp.num_instances, RAGGED_ROWS)
    ragged = hold_k4_ragged("2 icosphere instances", cfg, scene, icp, cam, quat, seed, row0,
                            RAGGED_ROWS)
    k4_frame["max_abs_err"] = max(k4_frame["max_abs_err"], ragged)
    return max(errs), k4_frame


def phase_c5_main(c5, c3, bvh3, quat, seed, device, card, k4):
    """The slice's main paths under the launch counters, timed; the
    profiler splits; K7 alone on a Phong frame, held to its plain version
    bit for bit, and its least time; -> the launches and K7's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.models.instanced import camera_rays, render_instanced_phong
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        instanced_ops,
        k7_bytes,
    )

    cs, ic, cam, cfg, scene = c5["cs"], c5["ic"], c5["cam"], c5["cfg"], c5["scene"]
    width, height = C5_SIZE
    phong = (ic.inst_tab, cs, c5["inst"].mat, c5["albedo"], cam)
    yaws = [torch.tensor(y, dtype=torch.float32, device=device)
            for y in np.linspace(0.0, 0.5, C5_FRAMES)]
    zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(C5_PT_FRAMES)]

    def rounds(label, fn, n_frames):
        """Best ms/frame of C5_ROUNDS rounds of n_frames chained frames (a
        warm-up first); fn(k) -> its ray count or None."""
        fn(0)
        best = None
        for r in range(C5_ROUNDS):
            rays = []
            ms, host_ms = cuda_ms(lambda k: rays.append(fn(k)), n_frames)
            n = None if rays[0] is None else int(torch.stack(rays).sum()) // n_frames
            rate = "" if n is None else f" = {n / ms / 1e3:.2f} Mrays/s, {n} rays/frame"
            log(f"  {label} round {r}: {ms:.4f} ms/frame (host enqueue {host_ms:.4f} ms){rate} "
                f"[{card}]")
            if best is None or ms < best[0]:
                best = (ms, n)
        return best

    def phong_frame(k, **kw):
        render_instanced_phong(*phong, yaws[k], c5["light"], **kw)

    reset_k4()
    kinst.launches = kbvh.launches = cluster.launches = pt.rebin_launches = 0
    hard_ms, _ = rounds(f"config 5 Phong orbit {width}x{height}, hard shadows", phong_frame,
                        C5_FRAMES)
    soft_ms, _ = rounds(f"config 5 soft-shadow orbit {width}x{height} {C5_SOFT}",
                        lambda k: phong_frame(k, **C5_SOFT), C5_SOFT_FRAMES)
    rebin_ms, rays5 = rounds(f"config 5 PT render_pt_rebin(bvh=ic) {cfg.width}x{cfg.height}",
                             lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=ic)[1], C5_PT_FRAMES)
    mega_ms, _ = rounds(f"config 5 PT render_pt_mega(bvh=ic) {cfg.width}x{cfg.height}",
                        lambda k: pt.render_pt_mega(cfg, scene, zs[k], quat, 1, seed=seed,
                                                    bvh=ic)[1], C5_PT_FRAMES)
    _, _, scene3, cfg3, _ = c3
    raw_ms, rays3 = rounds(f"config 3 render_pt_fast(bvh=raw BVH) {cfg3.width}x{cfg3.height}",
                           lambda k: render_pt_fast(cfg3, scene3, zs[k], quat, 1, seed=seed,
                                                    bvh=bvh3)[1], RAW_FRAMES)
    torch.cuda.synchronize(device)
    counts = {"K7": kinst.launches, "K8": kbvh.launches, "K4": pt.launches,
              "K5": pt.rebin_launches, "K6": cluster.launches}
    k4_instances = pt.mesh_launches["instances"]
    nb = cfg.max_bounces + 1

    def runs(n_frames):  # the warm-up and the timed rounds
        return 1 + C5_ROUNDS * n_frames

    want = {"K7": 2 * runs(C5_FRAMES) + (1 + C5_SOFT["shadow_samples"]) * runs(C5_SOFT_FRAMES),
            "K8": 2 * nb * runs(RAW_FRAMES), "K4": runs(C5_PT_FRAMES),
            "K5": nb * runs(C5_PT_FRAMES), "K6": 0}
    log(f"  launches on the slice's main paths {counts} (expected {want}: 2 K7 per hard-shadow "
        f"frame, {1 + C5_SOFT['shadow_samples']} per soft-shadow frame, {nb} K5 per rebin frame, "
        f"1 K4 per mega frame, {2 * nb} K8 per render_pt_fast frame: closest and shadow per "
        f"bounce)")
    if counts != want or k4_instances != counts["K4"]:
        raise AssertionError(f"config-5 / raw-BVH launch counts {counts} (K4 with instances "
                             f"{k4_instances}) != {want}")
    # K4 on the frame whose plain replay (phase 14) gave its bound
    k4_ms = device_ms(lambda _: pt.render_pt_mega(cfg, scene, c5["cam"], quat, 1, seed=seed,
                                                  bvh=ic), K4_REPS, "pt_kernel")
    log(f"  K4 config 5 PT {cfg.width}x{cfg.height}: {k4_ms:.4f} ms of device time a frame (the "
        f"profiler's), at {k4['bound_ms'] / k4_ms:.2%} of its bound {k4['bound_ms']:.5f} ms by "
        f"{k4['bound_by']} [{card}]")

    # profiler: K7 closest against any hit per Phong frame; K5 per bounce
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(phong_frame, C5_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if events:
        k7 = [e.time_range.elapsed_us() for e in events if "instanced_kernel" in e.name]
        busy = sum(e.time_range.elapsed_us() for e in events) / C5_FRAMES
        closest, anyhit = sum(k7[0::2]) / C5_FRAMES, sum(k7[1::2]) / C5_FRAMES
        log(f"  profile Phong orbit ({C5_FRAMES} frames, profiler on: {prof_ms:.4f} ms/frame): "
            f"K7 closest {closest:.1f} us + any hit {anyhit:.1f} us per frame; device busy "
            f"{busy:.1f} us/frame = {busy / 1e3 / hard_ms:.1%} of the unprofiled {hard_ms:.4f} "
            f"ms frame; the rest (Phong math, orders) {busy - closest - anyhit:.1f} us [{card}]")
    else:
        log("  profiler: no device events; the Phong split is not measured")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = cuda_ms(lambda k: pt.render_pt_rebin(cfg, scene, zs[k], quat, 1, seed=seed,
                                                          bvh=ic), C5_PT_FRAMES)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if events:
        k5 = [e.time_range.elapsed_us() for e in events if "pt_rebin_kernel" in e.name]
        per_bounce = [sum(k5[b::nb]) / C5_PT_FRAMES for b in range(nb)]
        busy = sum(e.time_range.elapsed_us() for e in events) / C5_PT_FRAMES
        log(f"  profile config 5 PT render_pt_rebin ({C5_PT_FRAMES} frames, profiler on: "
            f"{prof_ms:.4f} ms/frame): K5 by bounce {[round(x, 1) for x in per_bounce]} us; device "
            f"busy {busy:.1f} us/frame = {busy / 1e3 / rebin_ms:.1%} of the unprofiled "
            f"{rebin_ms:.4f} ms frame; the regroup and the rest {busy - sum(per_bounce):.1f} us "
            f"[{card}]")
    else:
        log("  profiler: no device events; the K5 split is not measured")

    # K7 alone on the camera rays of a Phong frame (closest + normal), and
    # its least time from the plain version's replay of the same rays
    o, d = camera_rays(cam, 0.0, width, height)
    o, d = tuple(x.contiguous() for x in o), tuple(x.contiguous() for x in d)
    # the frame's orders made once, as render_instanced_phong makes them, so
    # the timed loop enqueues the kernel alone: building them per call makes
    # the loop host-bound
    iorder, iorders = kinst.instance_orders(ic.inst_tab, cs, cam)
    kw = dict(attrs=True, iorder=iorder, iorders=iorders)
    got = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw)  # and warm-up
    k7_call = lambda k: kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw)  # noqa: E731
    ev_ms, host_ms = cuda_ms(k7_call, K7_REPS)
    ms = device_ms(lambda _: k7_call(0), K7_REPS, "instanced_kernel")
    kinst.work.update(gates=0, transforms=0)
    cluster.work.update(slabs=0, tests=0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    want = kinst.instanced_cluster_intersect_reference(ic.inst_tab, cs, o, d, **kw)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = hold_sweep(f"K7 config 5, Phong camera rays {width}x{height} (yaw 0), closest + normal",
                     got, want, "K7")
    tb = cluster.sweep_tables(cs)
    n = width * height
    tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, ic.inst_tab, iorders])
    n_bytes = k7_bytes(n, True, tables)  # a scalar t_max: no plane read
    n_ops = instanced_ops(kinst.work["gates"], kinst.work["transforms"], cluster.work["slabs"],
                          cluster.work["tests"])
    bound = bound_ms(n_bytes, n_ops)
    log(f"  K7 Phong camera rays {width}x{height} (closest + normal): kernel {ms:.4f} ms of "
        f"device time (CUDA events {ev_ms:.4f} ms, host enqueue {host_ms:.4f} ms), plain {plain_ms:.1f} ms; {kinst.work['gates']} instance "
        f"gates, {kinst.work['transforms']} transforms, {cluster.work['slabs']} box + "
        f"{cluster.work['tests']} triangle tests -> bound {bound[0]:.5f} ms by {bound[1]} "
        f"({n_bytes} B, {n_ops} ops), kernel at {bound[0] / ms:.2%} of it [{card}]")
    log(f"  config 5: Phong orbit {hard_ms:.4f} ms/frame = {1e3 / hard_ms:.1f} fps, soft shadows "
        f"{soft_ms:.4f} ms/frame; PT 512x512 rebin {rebin_ms:.4f} ms/frame = "
        f"{rays5 / rebin_ms / 1e3:.2f} Mrays/s, mega {mega_ms:.4f} ms/frame; config 3 raw BVH "
        f"render_pt_fast {raw_ms:.4f} ms/frame = {rays3 / raw_ms / 1e3:.2f} Mrays/s [{card}]")
    return {"launches": counts, "k7_err": err, "k4": {**k4, "ms": k4_ms},
            "k7": {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound[0], "bound_by": bound[1]}}


def time_k9(key, device, card):
    """K9 at K9_SHAPE by CUDA events over back-to-back calls and by
    torch.profiler, its plain version, and torch.rand at the same shape
    (Philox, another stream: for scale only)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng

    n, h, w = K9_SHAPE
    krng.uniform_key(key, n, h, w, device=device)  # warm-up
    ms, host_ms = cuda_ms(lambda k: krng.uniform_key(key, n, h, w, device=device), K9_REPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_ms(lambda k: krng.uniform_key(key, n, h, w, device=device), K9_REPS)
    k9 = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "rng_kernel" in e.name]
    device_ms = sum(k9) / len(k9) / 1e3 if k9 else None
    rng.uniform(key, n, h, w, device=device)
    plain_ms, _ = cuda_ms(lambda k: rng.uniform(key, n, h, w, device=device), 3)
    torch.rand(K9_SHAPE, device=device)
    rand_ms, _ = cuda_ms(lambda k: torch.rand(K9_SHAPE, device=device), K9_REPS)
    log(f"  K9 {K9_SHAPE}: {ms:.4f} ms by CUDA events (host enqueue {host_ms:.4f} ms), "
        + (f"{device_ms:.4f} ms device time by the profiler ({len(k9)} launches)"
           if k9 else "profiler: no device events, device time not measured")
        + f"; plain version {plain_ms:.2f} ms; torch.rand (Philox, another stream, for "
        f"scale only) {rand_ms:.4f} ms [{card}]")
    return ms, device_ms, plain_ms


def draws_match_plain(cfg2, scene, pos, quat, device):
    """Every K9 draw of one config-2 pass of the main path (global pass 0 of
    key=1), at threefry and at pallas: the key it was drawn under against
    the one the JAX package derives, and the kernel's planes against the
    plain version's on the same key and shape, bit for bit."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng
    from raytracing_engine_tpu_torch.ops.rng_pcg import to_int32
    from raytracing_engine_tpu_torch.pathtracer.wavefront import trace_pass_soa

    pkey = rng.fold_in(1, 0)
    nd = cfg2.max_bounces + 2  # the camera draw and one per bounce
    wants = {"threefry": [rng.fold_in(pkey, c) for c in range(nd)],
             "pallas": [rng.planes_key(to_int32(rng.key_to_seed(pkey) + c)) for c in range(nd)]}
    kernel = krng.uniform_key
    for mode, want_keys in wants.items():
        calls = []

        def recorded(key, n, h, w, row0=0, band_h=None, device=None):
            out = kernel(key, n, h, w, row0=row0, band_h=band_h, device=device)
            calls.append((rng.key_words(key), (n, h, w, row0, band_h), out))
            return out

        krng.uniform_key = recorded
        try:
            trace_pass_soa(dataclasses.replace(cfg2, rng=mode), scene, pos, quat, key=pkey)
        finally:
            krng.uniform_key = kernel
        keys = [c[0] for c in calls]
        shapes = sorted({c[1] for c in calls})
        same = [torch.equal(out, rng.uniform(k, *shape, device=device))
                for k, shape, out in calls]
        log(f"  {mode}: the {len(calls)} K9 draws of one config-2 pass, shapes (n, h, w, row0, "
            f"band_h) {shapes}: keys as the JAX package derives them {keys == want_keys}; "
            f"kernel == plain version bit for bit {sum(same)}/{len(same)}")
        if keys != want_keys or not all(same):
            raise AssertionError(f"the {mode} pass's K9 draws differ from the plain version "
                                 f"or were drawn under other keys: {keys} != {want_keys}")


def time_c4_routes(quat, c4, device, card):
    """progressive_render at config 4 (pcg) for C4_DEFAULT_CHUNKS chunks of
    16 passes: its default route (render_pt_fast, the plain wavefront with
    the pcg draws) and render_fn=render_pt_mega (K4), by CUDA events."""
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    cfg, scene, pos = c4
    spp = 16 * C4_DEFAULT_CHUNKS
    out = {}
    for label, fn in (("default route (render_pt_fast)", None),
                      ("render_fn=render_pt_mega (K4)", pt.render_pt_mega)):
        kw = {} if fn is None else {"render_fn": fn}
        state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
        for state in progressive_render(cfg, scene, state, 1, passes_per_chunk=1, **kw):
            pass  # warm-up
        state = ProgressiveState.start(cfg, pos, quat, key=1, device=device)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for state in progressive_render(cfg, scene, state, spp, **kw):
            pass
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        s = start.elapsed_time(end) / 1e3
        out[label] = (s, state.accum.mean().item() / spp)
        log(f"  config 4 {cfg_size(c4)} pcg, progressive_render {label}: {spp} spp "
            f"({C4_DEFAULT_CHUNKS} chunks of 16) in {s:.4f} s by CUDA events ({host_s:.4f} s "
            f"host) = {spp / s:.1f} spp/s, {C4_SPP} spp at this rate {C4_SPP / (spp / s):.2f} s "
            f"(extrapolated) [{card}]")
        if state.spp_done != spp or not torch.isfinite(state.accum).all():
            raise AssertionError(f"config 4 progressive_render {label} incomplete or non-finite")
    (fast_s, fast_mean), (mega_s, mega_mean) = out.values()
    log(f"  config 4: the default route takes {fast_s / mega_s:.1f}x K4's time; image means "
        f"{fast_mean:.6f} and {mega_mean:.6f}")


def phase_rng(quat, c2, c4, c3, bvh3, device, card):
    """K9 against its plain version and JAX's literal values; the threefry
    and pallas render_pt_fast at config 2 under the launch counters, timed;
    bands, progressive_render's default route, the mesh paths."""
    import dataclasses

    from raytracing_engine_tpu_torch.ops import rng
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse, cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import rng as krng
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast, trace_pass_soa
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render
    from raytracing_engine_tpu_torch.utils.timing import rng_bound_ms

    n, h, w = K9_SHAPE
    key = rng.fold_in(1, 0)
    got = krng.uniform_key(key, n, h, w, device=device)
    want = rng.uniform(key, n, h, w, device=device)
    err = (got - want).abs().max().item()
    row0, bh = K9_BAND
    band = krng.uniform_key(key, n, h, w, row0=row0, band_h=bh, device=device)
    band_want = rng.uniform(key, n, h, w, row0=row0, band_h=bh, device=device)
    ok = (torch.equal(got, want) and torch.equal(band, band_want)
          and torch.equal(band, got[:, row0:row0 + bh]))
    log(f"  K9 vs its plain version {K9_SHAPE} bit for bit: {torch.equal(got, want)} "
        f"(max_abs_err {err:.6g}); rows {row0}..{row0 + bh}: kernel == plain "
        f"{torch.equal(band, band_want)}, == rows of the full draw "
        f"{torch.equal(band, got[:, row0:row0 + bh])}; in [0, 1): "
        f"{bool(got.min() >= 0.0) and bool(got.max() < 1.0)}")
    if not ok or not (got.min() >= 0.0 and got.max() < 1.0):
        raise AssertionError("K9 disagrees with its plain version")
    rn, rh_, rw = K9_RAGGED
    rr0, rbh = K9_RAGGED_BAND
    rag = krng.uniform_key(key, rn, rh_, rw, device=device)
    rag_band = krng.uniform_key(key, rn, rh_, rw, row0=rr0, band_h=rbh, device=device)
    okr = (torch.equal(rag, rng.uniform(key, rn, rh_, rw, device=device))
           and torch.equal(rag_band, rng.uniform(key, rn, rh_, rw, rr0, rbh, device=device)))
    before = krng.launches
    empty = (krng.uniform_key(key, 0, rh_, rw, device=device).numel()
             + krng.uniform_key(key, rn, rh_, rw, row0=rr0, band_h=0, device=device).numel())
    log(f"  K9 vs its plain version at {K9_RAGGED} ({rh_ * rw} elements a plane, the last "
        f"block ragged) and rows {rr0}..{rr0 + rbh}, bit for bit: {okr}; empty draws counted "
        f"{krng.launches - before} launches (expected 0)")
    if not okr or empty or krng.launches != before:
        raise AssertionError("K9 disagrees with its plain version on a ragged plane, or an "
                             "empty draw counted a launch")
    for label, u, table in (
            ("jax.random.uniform(PRNGKey(0))", krng.uniform_key(0, n, h, w, device=device),
             JAX_UNIFORM_KEY0),
            ("uniform_planes(-7)", krng.uniform_planes(-7, n, h, w, device=device),
             JAX_PLANES_M7)):
        bits = {i: int(u[i].view(torch.int32).item()) & 0xFFFFFFFF for i in table}
        log(f"  K9 {label} at {len(table)} indices == JAX's: {bits == table}")
        if bits != table:
            raise AssertionError(f"K9 {label} differs from JAX: {bits} != {table}")

    # the slice's main path: render_pt_fast at config 2, threefry then pallas
    cfg2, scene, _ = c2
    zs = [torch.tensor([0.0, 0.0, 1e-3 + 1e-4 * k], device=device) for k in range(RNG_FRAMES)]
    krng.launches = pt.launches = 0
    krng.work["elements"] = 0
    renders, times = {}, {}
    for mode in ("threefry", "pallas"):
        cfg = dataclasses.replace(cfg2, rng=mode)
        renders[mode] = render_pt_fast(cfg, scene, zs[0], quat, C2_SPP, key=1)
        ms, host_ms = cuda_ms(lambda k: render_pt_fast(cfg, scene, zs[k], quat, C2_SPP, key=1),
                              RNG_FRAMES)
        times[mode] = ms
        log(f"  render_pt_fast rng={mode!r} {cfg_size(c2)} {C2_SPP} spp: {ms:.2f} ms/frame "
            f"(host enqueue {host_ms:.2f} ms; the plain wavefront around K9) [{card}]")
    torch.cuda.synchronize(device)
    launches, elements = krng.launches, krng.work["elements"]
    draws = C2_SPP * (cfg2.max_bounces + 2)  # the camera draw and one per bounce, a pass
    want = 2 * (1 + RNG_FRAMES) * draws
    log(f"  K9 launches on the main path {launches} (expected {want}: {draws} per render, "
        f"{1 + RNG_FRAMES} renders per rng mode), {elements} uniforms; K4 launches {pt.launches}")
    if launches != want or pt.launches != 0:
        raise AssertionError(f"K9 launches {launches} != {want} or K4 launched")
    draws_match_plain(cfg2, scene, zs[0], quat, device)

    ref, _ = pt.render_pt_mega(cfg2, scene, zs[0], quat, C2_SPP, seed=seed_from_int(1))
    for mode, (img, nr) in renders.items():
        rel = abs(img.mean().item() / ref.mean().item() - 1.0)
        log(f"  {mode}: finite {bool(torch.isfinite(img).all())}, mean {img.mean().item():.7f} "
            f"against K4's pcg {ref.mean().item():.7f} (relative {rel:.3e}, limit "
            f"{RNG_MEAN_RTOL}), {int(nr)} rays")
        if img.shape != ref.shape or not torch.isfinite(img).all() or rel > RNG_MEAN_RTOL:
            raise AssertionError(f"the {mode} render is off")

    pkey = rng.fold_in(1, 0)
    cfg = dataclasses.replace(cfg2, rng="threefry")
    full, _ = trace_pass_soa(cfg, scene, zs[0], quat, key=pkey)
    r0, rh = RNG_BAND
    part, _ = trace_pass_soa(cfg, scene, zs[0], quat, key=pkey, row0=r0, band_h=rh)
    log(f"  trace_pass_soa rows {r0}..{r0 + rh} == rows of the full pass bit for bit: "
        f"{torch.equal(part, full[r0:r0 + rh])}")
    if not torch.equal(part, full[r0:r0 + rh]):
        raise AssertionError("a threefry band differs from the rows of the full pass")

    # progressive_render's default route: render_pt_fast with the state's key
    time_c4_routes(quat, c4, device, card)
    cfg4 = dataclasses.replace(c4[0], rng="threefry")
    _, scene4, pos4 = c4
    state = ProgressiveState.start(cfg4, pos4, quat, key=1, device=device)
    for state in progressive_render(cfg4, scene4, state, 4, passes_per_chunk=2):
        pass
    one, _ = render_pt_fast(cfg4, scene4, pos4, quat, 4, key=1)
    okc = torch.allclose(state.accum, one * 4.0, rtol=C3_CHUNK_RTOL, atol=0.0)
    log(f"  progressive_render (default route, threefry) {cfg_size((cfg4,))} 2 x 2 spp vs one "
        f"4-spp render_pt_fast (sums) within rtol {C3_CHUNK_RTOL:.3g}: {okc}")
    if state.spp_done != 4 or not okc:
        raise AssertionError("progressive_render's threefry route depends on the chunking")

    _, cs, scene3, cfg3, _ = c3
    cfg3 = dataclasses.replace(cfg3, rng="threefry")
    pos3 = torch.zeros(3, device=device)
    cluster.launches = bvh_traverse.launches = krng.launches = 0
    img, _ = render_pt_fast(cfg3, scene3, pos3, quat, 1, key=1, bvh=cs)
    counts = {"K6": cluster.launches, "K9": krng.launches}
    state = ProgressiveState.start(cfg3, pos3, quat, key=1, device=device)
    for state in progressive_render(cfg3, scene3, state, 1, bvh=bvh3):
        pass
    torch.cuda.synchronize(device)
    counts["K8"], counts["K9"] = bvh_traverse.launches, krng.launches
    nb = cfg3.max_bounces + 1
    wantc = {"K6": 2 * nb, "K9": 2 * (nb + 1), "K8": 2 * nb}
    log(f"  config 3 threefry: render_pt_fast(bvh=cs) and progressive_render(bvh=raw BVH), "
        f"1 spp each: launches {counts} (expected {wantc}); lit "
        f"{(img.amax(-1) > 0).double().mean().item():.4f} and "
        f"{(state.accum.amax(-1) > 0).double().mean().item():.4f}")
    if counts != wantc or not (torch.isfinite(img).all() and torch.isfinite(state.accum).all()):
        raise AssertionError(f"config-3 threefry launch counts {counts} != {wantc}")

    k9_ms, device_ms, plain_ms = time_k9(key, device, card)
    bound = rng_bound_ms(n * h * w)
    log(f"  K9 bound {bound[0]:.5f} ms by {bound[1]} ({n * h * w} uniforms); kernel at "
        f"{bound[0] / k9_ms:.2%} of it by events [{card}]")
    return {"launches": launches, "max_abs_err": err, "ms": k9_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


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

    pt_quat, pt_seed, c2, c4 = pt_setup(device)
    log("phase 7: K4 vs its plain version (BASELINE configs 2 and 4)")
    pt_err = phase_pt_kernel(pt_quat, pt_seed, c2, c4)
    log("phase 8: path-tracer physics and invariants through K4")
    phase_pt_invariants(pt_quat, pt_seed, c2, c4, device)
    log("phase 9: path-tracer main path and timing (CUDA events)")
    pt_main = phase_pt_main(pt_quat, pt_seed, c2, c4, card, device)

    c3 = c3_setup(device)
    log("phase 10: BASELINE config 3's ClusterSet and K6 vs its plain version")
    k6 = phase_cluster_kernel(c3, pt_quat, pt_seed, device, card)
    log("phase 11: config 3 through K4, K5 and K6, and its invariants")
    inv = phase_c3_invariants(c3, pt_quat, pt_seed, device)
    phase_c3_warp_rays(c3, pt_quat, pt_seed, device)
    log("phase 12: config-3 main path and timing (CUDA events)")
    c3_main = phase_c3_main(c3, pt_quat, pt_seed, device, card, inv)
    log("phase 13: config 3's raw BVH and K8 vs its plain version")
    k8, bvh3 = phase_bvh_kernel(c3, pt_quat, pt_seed, device, card)
    c5 = c5_setup(device)
    log("phase 14: BASELINE config 5, K7 and the instanced paths vs their plain versions")
    k7_err, k4_inst = phase_instanced_kernel(c5, pt_quat, pt_seed, device)
    k7_err = max(k7_err, phase_c5_warp_rays(c5, pt_quat, pt_seed, device))
    log("phase 15: the slice's main paths and timing (CUDA events)")
    c5_main = phase_c5_main(c5, c3, bvh3, pt_quat, pt_seed, device, card, k4_inst)
    log("phase 16: kernel K9 and the threefry and pallas streams")
    k9 = phase_rng(pt_quat, c2, c4, c3, bvh3, device, card)

    # no single PyTorch call computes any of these kernels (torch.rand draws
    # Philox, not threefry): library_ms null
    src = "raytracing_engine_tpu_torch/csrc/conemarch.cu"
    kernels = [
        {"name": "pyramid_kernel (K1)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/depth.py:98",
         "launches": counts["depth"], "max_abs_err": errs["depth"], **times["depth"],
         "library_ms": None},
        {"name": "fused_kernel (K2)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/fused.py:30",
         "launches": counts["fused"], "max_abs_err": errs["fused"], **times["fused"],
         "library_ms": None},
        {"name": "shade_kernel (K3)", "route": "cuda", "source": src,
         "replaces": "raytracing_engine_tpu/ops/pallas/shade.py:194",
         "launches": counts["shade"], "max_abs_err": errs["shade"], **times["shade"],
         "library_ms": None},
        {"name": "pt_kernel<none> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "max_abs_err": pt_err, **pt_main, "library_ms": None},
        {"name": "pt_kernel<clusters> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "launches": c3_main["launches"]["K4"], **c3_main["k4"], "library_ms": None},
        {"name": "pt_kernel<instances> (K4)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:194",
         "launches": c5_main["launches"]["K4"], **c5_main["k4"], "library_ms": None},
        {"name": "pt_rebin_kernel (K5)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/pt.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/pt_kernel.py:699",
         "launches": c3_main["launches"]["K5"], "max_abs_err": inv["max_abs_err"],
         **c3_main["k5"], "library_ms": None},
        {"name": "cluster_kernel (K6)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/cluster.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/cluster_intersect.py:439",
         "launches": c3_main["launches"]["K6"], **k6, "library_ms": None},
        {"name": "instanced_kernel (K7)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/instanced.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/instanced_intersect.py:225",
         "launches": c5_main["launches"]["K7"],
         "max_abs_err": max(k7_err, c5_main["k7_err"]), **c5_main["k7"],
         "library_ms": None},
        {"name": "traverse_kernel (K8)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/bvh.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/bvh_traverse.py:60",
         "launches": c5_main["launches"]["K8"], **k8, "library_ms": None},
        {"name": "rng_kernel (K9)", "route": "cuda",
         "source": "raytracing_engine_tpu_torch/csrc/rng.cu",
         "replaces": "raytracing_engine_tpu/ops/pallas/rng.py:24", **k9, "library_ms": None},
    ]
    for k in kernels:  # a timing that failed fails the run
        bad = [key for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")
               if key in k and not math.isfinite(k[key])]
        if bad:
            raise AssertionError(f"{k['name']}: {bad} not finite")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
