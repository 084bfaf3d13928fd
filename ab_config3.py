#!/usr/bin/env python3
"""The mesh paths (BASELINE configs 3 and 5) at two checkouts of the port, on one GPU.

A/B: for checkout A, B, B, A in turn, each in a process of its own, builds
the checkout's kernels from its csrc/ (into its own build directory) and
prints ptxas's registers, stack, spills and shared memory of pt_kernel (K4),
pt_rebin_kernel (K5), instanced_kernel (K7), traverse_kernel (K8) and the
depth pyramid's kernel (K1: depth_kernel, one level a launch, or
pyramid_kernel, every level in one launch); then times, by CUDA events
(best of 3 rounds of chained frames with distinct camera z, host enqueue
beside):

  - BASELINE config 3 (benchmarks/run_all.py:120-148: the 70,400-triangle
    torus knot as a ClusterSet, 512x512, 2 bounces, 1 spp, pcg,
    seed_from_int(1)) through render_pt_mega and render_pt_rebin;
  - config 5's path-traced cell (:456-471: 30 instances of a 35,200-triangle
    knot, 512x512, 2 bounces) through both;
  - the sphere rows, K4 without a mesh: config 2 (:89-117:
    material_spheres, 800x608, 4 bounces, 4 spp) and material_spheres at
    1920x1088 and 4 spp (BASELINE.json's 1080p axis), each as frames and as
    the profiler's device time of one launch, and config 4 (:228-266:
    cornell_box, 256x256, 4 bounces) for 1024 spp through render_pt_mega in
    8 chunks of 128 passes (progressive_render's calls), with the device
    time of one chunk;

then, by torch.profiler's device time per launch: K5 alone by bounce on the
states of one config-3 and one config-5 frame, and K7 on config 5's Phong
camera rays at 1920x1088 (closest hit with normals) and on their hard-shadow
rays (any hit); the cone march at 1920x1088 (the default scene, 24 orbit
poses): the frame by CUDA events with its host enqueue, K1's device time a
frame (every K1 launch of the frame summed) and the pyramid's levels; K8 on
config 3's knot as a raw BVH (44,961 nodes): its camera, bounce-1 and
NEE-style shadow rays at 512x512 (as chip_smoke.py phase 13 makes them),
and render_pt_fast(bvh=BVH) 512x512 frames with K8's device time summed
over a frame's six launches. Every output (K1, K4, K5, K7, K8 and the
frames) is hashed; the parent process prints whether A's and B's hashes
agree. The card's name and power limit go with every number.

Tuning: --worker DIR NAME=VALUE ... runs a copy of DIR's package (in a
temporary directory; DIR is not touched) with each named constant set:
a `constexpr int NAME = ...;` of csrc/ or a module-level `NAME = ...` of
ops/cuda/, which must occur exactly once (for example kTraverseBlock=128
of csrc/bvh.cu, kPyramidMinBlocks=4 of csrc/conemarch.cu, or kBlockY=8
TILE_H=8 for the cone march's blocks and K1's mirrored tile).

Cone: the cone-march rows alone (ptxas, the 1920x1088 frame by events with
its enqueue, K1's device time a frame, hashes), for PAIRS pairs of runs in
the order A B B A A B B A ..., each run a process of its own; then each
run's numbers side by side and in how many pairs B's frame, enqueue and K1
time were below A's. --cone-worker DIR [NAME=VALUE ...] is one such run.

Spheres: the sphere rows alone, A B B A; they run on any checkout of the
port, also one without clusters (commit cee9bc9, spheres only).

Lanes: builds an instrumented copy of a checkout's per-thread sweep
(csrc/cluster.cuh cl::sweep, csrc/instanced.cuh instanced_sweep) in a
temporary directory (the checkout is not touched) and counts, for K5's
bounces at configs 3 and 5 and for K7's camera and shadow rays, the active
lanes of the warp (__popc(__activemask())) at each instance gate, super-box
gate, cluster-box gate, sub-box gate and 32-triangle sub-box test: the warp
execution efficiency of each level of the sweep, and the histogram of
lanes that test one sub-box together. It is meant for a checkout whose K5
and K7 run the per-thread sweep, such as commit df81868; where they run
the warp sweep only its serial sub-box scan carries a probe. It needs
csrc/instanced.cuh's per-thread instanced_sweep, which K4 ran until K4
took the warp sweep (commit 7a35006 is the last that has it): on a later
checkout it exits 1 without measuring.

Bound5: K5's least time for a config-5 frame (utils/timing.bound_ms),
from the work the plain rebin renderer counts on the whole frame, which it
holds to K4's frame bit for bit (about two minutes).

Usage: python3 ab_config3.py DIR_A DIR_B
       python3 ab_config3.py --spheres DIR_A DIR_B
       python3 ab_config3.py --cone DIR_A DIR_B [PAIRS]   (default 10)
       python3 ab_config3.py --lanes DIR
       python3 ab_config3.py --bound5 DIR
       python3 ab_config3.py --worker DIR [NAME=VALUE ...]   (one checkout, once)
       python3 ab_config3.py --sphere-worker DIR   (its sphere rows, once)
       python3 ab_config3.py --cone-worker DIR [NAME=VALUE ...]   (its cone rows, once)
(each DIR holds a raytracing_engine_tpu_torch package, e.g. a `git archive`
of a commit unpacked into a gitignored directory)
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

C3_FRAMES, C5_FRAMES, C2_FRAMES, HD_FRAMES, ROUNDS = 8, 4, 8, 4, 3
C4_SPP, C4_CHUNK = 1024, 128
BOUNCE_REPS, K7_REPS = 9, 10
SPIN_CYCLES = 2_000_000  # about 1 ms on the H100: device_ms's event timing
KERNELS = ("pt_kernel", "pt_rebin_kernel", "instanced_kernel", "traverse_kernel",
           "depth_kernel", "pyramid_kernel")
K1_NAMES = ("depth_kernel", "pyramid_kernel")  # K1 before and after it took every level
CONE_SIZE, CONE_POSES, K8_REPS, RAW_FRAMES = (1920, 1088), 24, 20, 3
C3_LIGHT = (6.0, 4.0, 6.0)
# K4's instantiations by mesh kind (csrc/pt.cuh kMeshNone, kMeshClusters,
# kMeshInstances); a checkout before them has one pt_kernel
MESH_KINDS = {0: "none", 1: "clusters", 2: "instances"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_lines(log: str):
    """(kernel, registers, stack B, spill stores B, spill loads B, smem B) of
    each entry of KERNELS in nvcc's -Xptxas -v log; an instantiation of K4 on
    a mesh kind is named pt_kernel<kind>."""
    out, entry, stack = [], None, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = next((k for k in KERNELS if re.search(rf"\d{k}[EI]", m.group(1))), None)
            kind = re.search(r"\dpt_kernelILi(\d+)E", m.group(1))
            if name and kind:
                name = f"{name}<{MESH_KINDS.get(int(kind.group(1)), kind.group(1))}>"
            entry, stack = name, None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            stack = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((entry, int(m.group(1)), *(stack or (0, 0, 0)),
                        int(smem.group(1)) if smem else 0))
            entry = None
    return out


def setup(device):
    """(config 3, config 5) as chip_smoke.py builds them."""
    import numpy as np
    import torch

    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        make_instanced_clusters,
        torus_knot,
    )
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    mats_t = np.zeros(mesh.shape[0], np.int32)
    cs = build_clusters(mesh, tri_mats=mats_t, device=device)
    scene = build_pt_scene(
        spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
        triangles=mesh, tri_mats=mats_t, device=device,
        materials=[{"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}])
    c3 = dict(cfg=PTConfig(width=512, height=512, max_bounces=2, rng="pcg"), scene=scene, bvh=cs,
              mesh=mesh)

    knot = torus_knot(segments=550, sides=32)
    base = build_clusters(knot, device=device)
    inst = grid_instances(build_bvh(knot, device=device), nx=6, ny=5, spacing=4.0,
                          base=(0.0, 14.0, 0.0), mats=np.arange(30, dtype=np.int32) % 3,
                          device=device)
    scene5 = build_pt_scene(
        spheres=[((8.0, 2.0, 10.0), 2.0, 3), ((0.0, 14.0, -103.0), 100.0, 4)],
        materials=[{"albedo": (0.75, 0.5, 0.3), "kind": DIFFUSE},
                   {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (40.0, 38.0, 34.0), "kind": DIFFUSE},
                   {"albedo": (0.55, 0.55, 0.5), "kind": DIFFUSE}], device=device)
    ic = make_instanced_clusters(inst, base, scene=scene5, device=device)
    c5 = dict(cfg=PTConfig(width=512, height=512, max_bounces=2, rng="pcg"), scene=scene5, bvh=ic,
              cs=base, inst=inst, light=torch.tensor((6.0, 2.0, 8.0), device=device))
    return c3, c5


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bounce_states(c, quat, seed, device):
    """(run_bounce, the input state of each bounce of one frame: None, then
    the regrouped states, as render_pt_rebin's default "none,morton" makes
    them)."""
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import pt

    pos = torch.zeros(3, device=device)
    _, _, run = pt.rebin_bounce_launcher(c["cfg"], c["scene"], pos, quat, seed, c["bvh"])
    modes = pt._gap_modes("none,morton")
    inputs, st = [None], run(0, None, 0)[0]
    for b in range(1, c["cfg"].max_bounces + 1):
        st = pt.regroup(st, modes[min(b - 1, len(modes) - 1)])
        inputs.append(st.clone())
        st = run(b, st, 0)[0]
    return run, inputs, st


def phong_rays(c5, device):
    """Config 5's Phong camera rays at 1920x1088 (yaw 0) with the frame's
    orders, and the hard-shadow rays render_instanced_phong casts from their
    closest hits: (cam (o, d, kw), shadow (o, d, kw))."""
    import torch

    from raytracing_engine_tpu_torch.models.instanced import camera_rays, shadow_rays
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst

    cam = torch.zeros(3, device=device)
    ic, cs = c5["bvh"], c5["cs"]
    o, d = camera_rays(cam, 0.0, 1920, 1088)
    o, d = tuple(x.contiguous() for x in o), tuple(x.contiguous() for x in d)
    iorder, iorders = kinst.instance_orders(ic.inst_tab, cs, cam)
    kw = dict(iorder=iorder, iorders=iorders)
    hits = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, attrs=True, **kw)
    so, sd, tm = shadow_rays(o, d, hits, c5["light"])
    so, sd = tuple(x.contiguous() for x in so), tuple(x.contiguous() for x in sd)
    return (o, d, dict(attrs=True, **kw)), (so, sd, dict(any_hit=True, t_max=tm, **kw))


def device_ms(launch, reps: int, name: str, setup=lambda k: None) -> float:
    """Median device time (ms) of kernel `name` over reps calls of
    launch(setup(k)), setup's work made before each call, by torch.profiler;
    where three profiled runs record no device event, by CUDA events around
    each call enqueued behind a spin kernel (so they bracket the kernel, not
    the host's enqueue). Raises unless the time is finite and positive."""
    import math

    import torch
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
        print(f"  {name}: no device event in 3 profiled runs; CUDA events behind a spin kernel",
              flush=True)
    if not (math.isfinite(ms) and ms > 0.0):
        raise RuntimeError(f"{name}: no device time measured ({ms})")
    return ms


def device_sum_ms(launch, reps: int, names) -> tuple[float, list]:
    """Device time (ms) of the kernels whose names contain one of `names`,
    summed over each of reps calls of launch(k) and averaged, by
    torch.profiler (after one call outside it); and the mean time of each
    such launch by its place in the call. Where three profiled runs record
    no device event, by CUDA events around each call enqueued behind a spin
    kernel (the call's gaps between launches included), places not split.
    Raises unless the time is finite and positive."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    launch(reps)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(reps):
                launch(k)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in sorted(prof.events(),
                                                         key=lambda e: e.time_range.start)
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(n in e.name for n in names)]
        if us and len(us) % reps == 0:
            per = len(us) // reps
            ms = sum(us) / 1e3 / reps
            places = [sum(us[i::per]) / 1e3 / reps for i in range(per)]
            break
    else:
        times = []
        for k in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            launch(k)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms, places = sum(times) / reps, []
        print(f"  {names}: no whole set of device events in 3 profiled runs; CUDA events behind "
              "a spin kernel", flush=True)
    if not (math.isfinite(ms) and ms > 0.0):
        raise RuntimeError(f"{names}: no device time measured ({ms})")
    return ms, places


def frames(root, card, label, fn, c, quat, seed, n_frames, spp=1, kernel=None, summed=False):
    """Best ms/frame of ROUNDS rounds of n_frames chained frames with distinct
    camera z by CUDA events (host enqueue beside), the image's hash and,
    with `kernel`, the profiler's device time of that kernel in one frame
    (with `summed`, of every launch of it in the frame)."""
    import torch

    device = quat.device
    kw = dict(seed=seed) if c.get("bvh") is None else dict(seed=seed, bvh=c["bvh"])
    zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(n_frames)]
    img, _ = fn(c["cfg"], c["scene"], zs[0], quat, spp, **kw)
    best = None
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for k in range(n_frames):
            fn(c["cfg"], c["scene"], zs[k], quat, spp, **kw)
        host = (time.perf_counter() - t0) * 1e3 / n_frames
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n_frames
        if best is None or ms < best[0]:
            best = (ms, host)
    dev = ""
    if kernel and summed:
        dev_ms, places = device_sum_ms(
            lambda k: fn(c["cfg"], c["scene"], zs[k % n_frames], quat, spp, **kw),
            BOUNCE_REPS, (kernel,))
        dev = (f", {kernel} {dev_ms:.4f} ms a frame (device time, {len(places)} launches: "
               f"{' / '.join(f'{x:.4f}' for x in places)})")
    elif kernel:
        dev_ms = device_ms(lambda k: fn(c["cfg"], c["scene"], zs[k % n_frames], quat, spp, **kw),
                           BOUNCE_REPS, kernel, setup=lambda k: k)
        dev = f", {kernel} {dev_ms:.4f} ms (device time)"
    print(f"  {root}: {label}: best {best[0]:.4f} ms/frame (host enqueue {best[1]:.4f} ms)"
          f"{dev}, image {digest(img)} [{card}]", flush=True)


def sphere_rows(root, card, device, quat, seed):
    """K4 without a mesh: config 2 and the 1080p row as frames, config 4's
    1024 spp in progressive_render's chunks. Only what the spheres-only
    checkout cee9bc9 already has is called."""
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes

    spheres = scenes.material_spheres(device)
    c2 = dict(cfg=PTConfig(width=800, height=608, max_bounces=4, rng="pcg"), scene=spheres)
    hd = dict(cfg=PTConfig(width=1920, height=1088, max_bounces=4, rng="pcg"), scene=spheres)
    frames(root, card, "config 2 800x608 4 spp render_pt_mega", pt.render_pt_mega, c2, quat, seed,
           C2_FRAMES, spp=4, kernel="pt_kernel")
    frames(root, card, "material_spheres 1920x1088 4 spp render_pt_mega", pt.render_pt_mega, hd,
           quat, seed, HD_FRAMES, spp=4, kernel="pt_kernel")

    cfg4 = PTConfig(width=256, height=256, max_bounces=4, rng="pcg")
    cornell, pos = scenes.cornell_box(device=device), torch.tensor([0.0, 0.2, 0.0], device=device)

    def c4_render():
        acc = torch.zeros((cfg4.height, cfg4.width, 3), device=device)
        for done in range(0, C4_SPP, C4_CHUNK):
            img, _ = pt.render_pt_mega(cfg4, cornell, pos, quat, C4_CHUNK, seed=seed,
                                       spp_offset=done)
            acc = acc + img * float(C4_CHUNK)
        return acc

    acc = c4_render()
    best = None
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        c4_render()
        host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        s = start.elapsed_time(end) / 1e3
        if best is None or s < best[0]:
            best = (s, host)
    chunk = device_ms(lambda k: pt.render_pt_mega(cfg4, cornell, pos, quat, C4_CHUNK, seed=seed,
                                                  spp_offset=C4_CHUNK * (k % 8)),
                      BOUNCE_REPS, "pt_kernel", setup=lambda k: k)
    print(f"  {root}: config 4 256x256 {C4_SPP} spp render_pt_mega ({C4_SPP // C4_CHUNK} chunks): "
          f"best {best[0]:.4f} s (host enqueue {best[1]:.4f} s), pt_kernel {chunk:.4f} ms a "
          f"{C4_CHUNK}-spp chunk (device time), image {digest(acc)} [{card}]", flush=True)


def cone_rows(root, card, device):
    """The cone march at CONE_SIZE: frames of the CONE_POSES orbit poses by
    CUDA events (best of ROUNDS, host enqueue beside), K1's device time a
    frame and by launch, the first frame's image and pyramid hashed."""
    import torch

    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import cuda_renderer

    cfg = rtt.RenderConfig(*CONE_SIZE)
    scene = rtt.default_scene(device)
    positions, rotations = orbit_path(CONE_POSES, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)

    def render(k):
        return cuda_renderer.render(cfg, scene, positions[k % CONE_POSES], quats[k % CONE_POSES])

    img = render(0)
    levels = cuda_renderer.render_depth_pyramid(cfg, scene, positions[0], quats[0])
    best = None
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for k in range(CONE_POSES):
            render(k)
        host = (time.perf_counter() - t0) * 1e3 / CONE_POSES
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / CONE_POSES
        if best is None or ms < best[0]:
            best = (ms, host)
    k1, places = device_sum_ms(render, CONE_POSES, K1_NAMES)
    size = f"{cfg.width}x{cfg.height}"
    print(f"  {root}: cone march {size} frame: best {best[0]:.4f} ms/frame (host enqueue "
          f"{best[1]:.4f} ms), K1 {k1:.4f} ms a frame (device time; {len(places)} launches a "
          f"frame: {' / '.join(f'{x:.4f}' for x in places)}), image {digest(img)} [{card}]",
          flush=True)
    print(f"  {root}: cone march {size} pyramid: {len(levels)} levels, outputs "
          f"{digest(*levels)} [{card}]", flush=True)
    return best[0], best[1], k1


def k8_rows(root, card, device, c3, quat, seed):
    """K8 on config 3's knot as a raw BVH: the camera, bounce-1 and NEE-style
    shadow rays of chip_smoke.py phase 13 (device time, outputs hashed), and
    render_pt_fast(bvh=BVH) frames with K8's device time summed a frame."""
    import torch

    from raytracing_engine_tpu_torch.accel import build_bvh
    from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import (
        BVH_MAX_STEPS,
        _camera_rays,
        render_pt_fast,
    )

    cfg, scene = c3["cfg"], c3["scene"]
    bvh = build_bvh(c3["mesh"], device=device)
    tables = kbvh.tables_of(bvh)
    pos = torch.zeros(3, device=device)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = (tuple(x.contiguous() for x in r) for r in _camera_rays(cfg, pos, quat, u[0], u[1]))
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, c3["bvh"])
    state, _ = run(0, None, 0)
    o1 = tuple(state[a].clone() for a in range(3))
    d1 = tuple(state[3 + a].clone() for a in range(3))
    light = torch.tensor(C3_LIGHT, device=device)
    to_l = tuple(light[a] - o1[a] for a in range(3))
    dist = torch.sqrt(to_l[0] * to_l[0] + to_l[1] * to_l[1] + to_l[2] * to_l[2])
    wi = tuple(c / dist for c in to_l)
    total = 0.0
    for label, o, d, t_max, kw in (
            ("camera rays, closest", o0, d0, float("inf"), {}),
            ("bounce-1 rays, closest", o1, d1, float("inf"), {}),
            ("bounce-1 NEE shadow rays, any hit", o1, wi, dist * 0.999, dict(any_hit=True))):
        out = kbvh.bvh_intersect_packet(tables, o, d, t_max, max_steps=BVH_MAX_STEPS, **kw)
        ms = device_ms(lambda _, o=o, d=d, t_max=t_max, kw=kw: kbvh.bvh_intersect_packet(
            tables, o, d, t_max, max_steps=BVH_MAX_STEPS, **kw), K8_REPS, "traverse_kernel")
        total += ms
        print(f"  {root}: K8 config 3 raw BVH {cfg.width}x{cfg.height} {label}: {ms:.4f} ms "
              f"(device time), outputs {digest(*out)} [{card}]", flush=True)
    print(f"  {root}: K8 config 3 raw BVH: the three ray sets {total:.4f} ms [{card}]", flush=True)
    frames(root, card, "config 3 512x512 render_pt_fast(bvh=BVH)", render_pt_fast,
           dict(cfg=cfg, scene=scene, bvh=bvh), quat, seed, RAW_FRAMES, kernel="traverse_kernel",
           summed=True)


def variant(root: str, settings) -> Path:
    """A copy of root's package in a temporary directory with each NAME=VALUE
    of `settings` set (see the module docstring); -> the copy's root."""
    tmp = Path(tempfile.mkdtemp(prefix="ab_variant_"))
    pkg = tmp / "raytracing_engine_tpu_torch"
    shutil.copytree(Path(root) / "raytracing_engine_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    files = sorted((pkg / "csrc").glob("*.cu*")) + sorted((pkg / "ops" / "cuda").glob("*.py"))
    for item in settings:
        name, value = item.split("=", 1)
        pattern = re.compile(rf"^(\s*constexpr int {name} = )[^;\n]+;|^({name} = )\S+$", re.M)
        hits = [(f, m) for f in files for m in pattern.finditer(f.read_text())]
        if len(hits) != 1:
            raise SystemExit(f"ab_config3: {name} is set {len(hits)} times in {root}, not once")
        f, m = hits[0]
        text = f.read_text()
        new = f"{m.group(1)}{value};" if m.group(1) else f"{m.group(2)}{value}"
        f.write_text(text[:m.start()] + new + text[m.end():])
    return tmp


def sphere_worker(root: str) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import common
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int

    if not torch.cuda.is_available():
        print("ab_config3: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    info = common.build()
    for name, regs, stack, st, ld, smem in ptxas_lines(info["log"]):
        print(f"  {root}: ptxas {name}: {regs} registers, {stack} B stack, spill stores {st} B / "
              f"loads {ld} B, {smem} B static smem", flush=True)
    sphere_rows(root, card, device, torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
                seed_from_int(1))
    return 0


def cone_worker(root: str, settings=()) -> int:
    path = variant(root, settings) if settings else Path(root).resolve()
    root = root + (f" [{' '.join(settings)}]" if settings else "")
    sys.path.insert(0, str(path))
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import common

    if not torch.cuda.is_available():
        print("ab_config3: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    info = common.build()
    for name, regs, stack, st, ld, smem in ptxas_lines(info["log"]):
        if name in K1_NAMES:
            print(f"  {root}: ptxas {name}: {regs} registers, {stack} B stack, spill stores {st} "
                  f"B / loads {ld} B, {smem} B static smem", flush=True)
    frame, host, k1 = cone_rows(root, card, torch.device("cuda", 0))
    print(f"CONE {frame} {host} {k1}", flush=True)
    if settings:
        shutil.rmtree(path, ignore_errors=True)
    return 0


def cone_ab(a: str, b: str, pairs: int) -> int:
    """PAIRS pairs of --cone-worker runs, A B B A A B ...; see the module
    docstring."""
    runs, hashes = {a: [], b: []}, {}
    order = [(a, b) if k % 2 == 0 else (b, a) for k in range(pairs)]
    for pair in order:
        for root in pair:
            proc = subprocess.run([sys.executable, __file__, "--cone-worker", root], timeout=300,
                                  capture_output=True, text=True)
            sys.stdout.write("".join(line + "\n" for line in proc.stdout.splitlines()
                                     if not line.startswith("CONE ")))
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                return proc.returncode
            line = next(x for x in proc.stdout.splitlines() if x.startswith("CONE "))
            runs[root].append(tuple(float(x) for x in line.split()[1:]))
            for m in re.finditer(r": (cone march .*?): .*(?:image|outputs) (\w{16})", proc.stdout):
                hashes.setdefault(m.group(1), set()).add(m.group(2))
    for label, i in (("frame ms (events)", 0), ("host enqueue ms", 1), ("K1 ms a frame", 2)):
        below = sum(y[i] < x[i] for x, y in zip(runs[a], runs[b]))
        print(f"{label}: A {' '.join(f'{x[i]:.4f}' for x in runs[a])}; "
              f"B {' '.join(f'{y[i]:.4f}' for y in runs[b])}; B below A in {below} of {pairs} "
              f"pairs [{card_line()}]", flush=True)
    same = all(len(v) == 1 for v in hashes.values())
    print(f"outputs equal at A and B bit for bit (sha256 of every output): {same}", flush=True)
    return 0 if same else 1


def worker(root: str, settings=()) -> int:
    path = variant(root, settings) if settings else Path(root).resolve()
    root = root + (f" [{' '.join(settings)}]" if settings else "")
    sys.path.insert(0, str(path))
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import common, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int

    if not torch.cuda.is_available():
        print("ab_config3: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    info = common.build()
    for name, regs, stack, st, ld, smem in ptxas_lines(info["log"]):
        print(f"  {root}: ptxas {name}: {regs} registers, {stack} B stack, spill stores {st} B / "
              f"loads {ld} B, {smem} B static smem", flush=True)
    c3, c5 = setup(device)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    seed = seed_from_int(1)

    for cname, c, n in (("config 3", c3, C3_FRAMES), ("config 5 PT", c5, C5_FRAMES)):
        frames(root, card, f"{cname} 512x512 render_pt_mega", pt.render_pt_mega, c, quat, seed, n,
               kernel="pt_kernel")
        frames(root, card, f"{cname} 512x512 render_pt_rebin", pt.render_pt_rebin, c, quat, seed, n)
    sphere_rows(root, card, device, quat, seed)

    for cname, c in (("config 3", c3), ("config 5 PT", c5)):
        run, inputs, last = bounce_states(c, quat, seed, device)
        per = [device_ms(lambda y, b=b: run(b, y, 0), BOUNCE_REPS, "pt_rebin_kernel",
                         setup=lambda k, x=x: None if x is None else x.clone())
               for b, x in enumerate(inputs)]
        print(f"  {root}: K5 {cname} 512x512 by bounce (device time): "
              f"{' / '.join(f'{x:.4f}' for x in per)} ms = {sum(per):.4f} ms, last state "
              f"{digest(last)} [{card}]", flush=True)

    cam, shadow = phong_rays(c5, device)
    ic, cs = c5["bvh"], c5["cs"]
    for label, (o, d, kw) in (("camera rays, closest + normal", cam),
                              ("hard-shadow rays, any hit", shadow)):
        out = kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw)
        ms = device_ms(lambda _: kinst.instanced_cluster_intersect(ic.inst_tab, cs, o, d, **kw),
                       K7_REPS, "instanced_kernel")
        print(f"  {root}: K7 config 5 Phong 1920x1088 {label}: {ms:.4f} ms (device time), "
              f"outputs {digest(*out)} [{card}]", flush=True)
    cone_rows(root, card, device)
    k8_rows(root, card, device, c3, quat, seed)
    if settings:
        shutil.rmtree(path, ignore_errors=True)
    return 0


# --- K5's config-5 bound (--bound5) ------------------------------------------

def bound5(root: str) -> int:
    """K5's least time for a config-5 frame: the plain rebin render of the
    whole 512x512 frame (held to K4's bit for bit) counts the work of every
    bounce's rays (ops/cuda/instanced.work, ops/cuda/cluster.work); bytes as
    chip_smoke.py counts K5's config-3 bound. About two minutes: the plain
    two-level sweep is a Python loop over instances and boxes."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.utils.timing import (
        bound_ms,
        cluster_table_bytes,
        instanced_ops,
        k5_bytes,
        pt_ops,
    )

    card = card_line()
    device = torch.device("cuda", 0)
    _, c5 = setup(device)
    ic, cs, cfg, scene = c5["bvh"], c5["cs"], c5["cfg"], c5["scene"]
    cam, quat, seed = torch.zeros(3, device=device), torch.tensor([0.0, 0.0, 0.0, 1.0],
                                                                  device=device), seed_from_int(1)
    k4, n4 = pt.render_pt_mega(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    kinst.work.update(gates=0, transforms=0)
    cluster.work.update(slabs=0, tests=0)
    t0 = time.perf_counter()
    img, n = pt.render_pt_rebin_reference(cfg, scene, cam, quat, 1, seed=seed, bvh=ic)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = torch.equal(img, k4) and int(n) == int(n4)
    fi = kinst.FrameInstances.at(ic, cam)
    tb = cluster.sweep_tables(cs)
    tables = cluster_table_bytes([tb.sbox, tb.crec, tb.trec, tb.tsmooth, ic.inst_tab,
                                  fi.iorder, fi.iorders])
    tables += 4 * sum(t.numel() for t in pt.pack_pt_scene(pt.kernel_scene(scene, ic))[:4])
    ops = instanced_ops(kinst.work["gates"], kinst.work["transforms"], cluster.work["slabs"],
                        cluster.work["tests"]) + pt_ops(int(n), int(scene.sph_count), 0)
    n_bytes = k5_bytes(cfg.width * cfg.height, cfg.max_bounces, tables)
    bound = bound_ms(n_bytes, ops)
    print(f"  {root}: K5 config 5 {cfg.width}x{cfg.height} frame: the plain rebin render of the "
          f"whole frame == K4's bit for bit: {same} (plain {plain_s:.1f} s); work "
          f"{kinst.work['gates']} instance gates, {kinst.work['transforms']} transforms, "
          f"{cluster.work['slabs']} box + {cluster.work['tests']} triangle tests, {int(n)} rays "
          f"x {int(scene.sph_count)} spheres -> bound {bound[0]:.5f} ms by {bound[1]} "
          f"({n_bytes} B, {ops} ops) [{card}]", flush=True)
    return 0 if same else 1


# --- the instrumented copy (--lanes) -----------------------------------------

LEVELS = ("instance gate", "super gate", "cluster gate", "sub gate", "sub-box test")
PROBE = """
namespace cl {
__device__ unsigned long long g_lanes[5][33];
// one count per warp-level event: the number of lanes that run it together
__device__ __forceinline__ void probe(int level) {
  const unsigned m = __activemask();
  unsigned lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  if (lane == static_cast<unsigned>(__ffs(m) - 1)) atomicAdd(&g_lanes[level][__popc(m)], 1ull);
}
}  // namespace cl
extern "C" int probe_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cl::g_lanes, sizeof(cl::g_lanes)));
}
extern "C" int probe_reset() {
  static const unsigned long long zero[5][33] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cl::g_lanes, zero, sizeof(zero)));
}
"""
PATCHES = {
    "cluster.cuh": [
        ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + PROBE),
        ("    if (!box_gate(tb.sbox + s * 8,",
         "    probe(1);\n    if (!box_gate(tb.sbox + s * 8,"),
        ("      if (!box_gate(cr, o, inv,", "      probe(2);\n      if (!box_gate(cr, o, inv,"),
        ("        if (box_gate(cr + kSubOff",
         "        probe(3);\n        if (box_gate(cr + kSubOff"),
        ("  const int base = c * kCluster + sub * kSubTris;\n  const float4* rec",
         "  probe(4);\n  const int base = c * kCluster + sub * kSubTris;\n  const float4* rec"),
    ],
    "instanced.cuh": [
        ("    if (!cl::box_gate(r + kBoxOff,",
         "    cl::probe(0);\n    if (!cl::box_gate(r + kBoxOff,"),
    ],
}


def lanes(root: str) -> int:
    import ctypes

    tmp = Path(tempfile.mkdtemp(prefix="ab_lanes_"))
    pkg = tmp / "raytracing_engine_tpu_torch"
    shutil.copytree(Path(root) / "raytracing_engine_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for name, edits in PATCHES.items():
        path = pkg / "csrc" / name
        src = path.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                print(f"ab_config3 --lanes: {root} has no per-thread sweep to instrument "
                      f"({name}: {old.strip()[:40]!r})", file=sys.stderr)
                return 1
            src = src.replace(old, new)
        path.write_text(src)
    sys.path.insert(0, str(tmp))
    import numpy as np
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import common
    from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int

    card = card_line()
    device = torch.device("cuda", 0)
    common.build()
    c3, c5 = setup(device)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    seed = seed_from_int(1)

    def counted(lib_name, fn):
        lib = common.library(lib_name)
        lib.probe_reset.argtypes, lib.probe_reset.restype = [], ctypes.c_int
        lib.probe_read.argtypes, lib.probe_read.restype = [ctypes.c_void_p], ctypes.c_int
        torch.cuda.synchronize()
        if lib.probe_reset() != 0:
            raise RuntimeError("probe_reset failed")
        fn()
        torch.cuda.synchronize()
        hist = np.zeros((5, 33), np.uint64)
        if lib.probe_read(ctypes.c_void_p(hist.ctypes.data)) != 0:
            raise RuntimeError("probe_read failed")
        return hist.astype(np.float64)

    def report(label, hist):
        parts = []
        for lv, row in zip(LEVELS, hist):
            n = row.sum()
            if n == 0:
                continue
            mean = (row * np.arange(33)).sum() / n
            parts.append(f"{lv} {int(n)} warp events, {mean:.2f} lanes ({mean / 32:.1%})")
        print(f"  {root}: {label}: " + "; ".join(parts) + f" [{card}]", flush=True)
        row = hist[4]
        if row.sum():
            cum = np.cumsum(row) / row.sum()
            tests = (row * np.arange(33)).sum()
            print(f"  {root}: {label}: lanes testing one sub-box together (warp events at m "
                  f"lanes): " + " ".join(f"{m}:{int(row[m])}" for m in range(1, 33) if row[m])
                  + f"; share of events with m <= 4 / 8 / 16: {cum[4]:.3f} / {cum[8]:.3f} / "
                  f"{cum[16]:.3f}; share of ray tests at m <= 8: "
                  f"{(row[:9] * np.arange(9)).sum() / tests:.3f}", flush=True)

    for cname, c in (("config 3", c3), ("config 5 PT", c5)):
        run, inputs, _ = bounce_states(c, quat, seed, device)
        for b, x in enumerate(inputs):
            hist = counted("pt", lambda b=b, x=x: run(b, None if x is None else x.clone(), 0))
            report(f"K5 {cname} 512x512 bounce {b}", hist)
    cam, shadow = phong_rays(c5, device)
    ic, cs = c5["bvh"], c5["cs"]
    for label, (o, d, kw) in (("K7 config 5 Phong camera rays", cam),
                              ("K7 config 5 Phong hard-shadow rays", shadow)):
        hist = counted("instanced",
                       lambda o=o, d=d, kw=kw: kinst.instanced_cluster_intersect(
                           ic.inst_tab, cs, o, d, **kw))
        report(label, hist)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2], sys.argv[3:])
    if len(sys.argv) == 3 and sys.argv[1] == "--lanes":
        return lanes(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--bound5":
        return bound5(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphere-worker":
        return sphere_worker(sys.argv[2])
    if len(sys.argv) >= 3 and sys.argv[1] == "--cone-worker":
        return cone_worker(sys.argv[2], sys.argv[3:])
    if len(sys.argv) in (4, 5) and sys.argv[1] == "--cone":
        return cone_ab(sys.argv[2], sys.argv[3], int(sys.argv[4]) if len(sys.argv) == 5 else 10)
    mode = "--worker"
    if len(sys.argv) == 4 and sys.argv[1] == "--spheres":
        mode = "--sphere-worker"
        del sys.argv[1]
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    hashes = {}
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, mode, root], timeout=900,
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        for line in proc.stdout.splitlines():
            m = re.search(r": (.*?): .*(?:image|state|outputs) (\w{16})", line)
            if m:
                hashes.setdefault(m.group(1), {}).setdefault(root, set()).add(m.group(2))
    same = {k: len({h for s in v.values() for h in s}) == 1 for k, v in hashes.items()}
    print(f"outputs equal at A and B bit for bit (sha256 of every output): "
          f"{all(same.values())} {same}", flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
