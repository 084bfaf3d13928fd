#!/usr/bin/env python3
"""The mesh paths (BASELINE configs 3 and 5) at two checkouts of the port, on one GPU.

A/B: for checkout A, B, B, A in turn, each in a process of its own, builds
the checkout's kernels from its csrc/ (into its own build directory) and
prints ptxas's registers, stack, spills and shared memory of pt_kernel (K4),
pt_rebin_kernel (K5), instanced_kernel (K7), traverse_kernel (K8), the
depth pyramid's kernel (K1: depth_kernel, one level a launch, or
pyramid_kernel, every level in one launch), fused_kernel (K2),
shade_kernel (K3) and cluster_kernel (K6); then times, by CUDA events
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
frame (every K1 launch of the frame summed), K2's device time a frame and
the pyramid's levels, the two-kernel frame by events and K3's device time
a frame (K3 on each pose's finished depth); K8 on config 3's knot as a raw
BVH (44,961 nodes): its camera, bounce-1 and NEE-style shadow rays at
512x512 (as chip_smoke.py phase 13 makes them), and render_pt_fast(bvh=BVH)
512x512 frames with K8's device time summed over a frame's six launches; K6 on
config 3's ClusterSet: the same three ray sets (closest-hit sweeps with the
frame's visit orders, as chip_smoke.py phase 10 makes them), and
render_pt_fast(bvh=cs) 512x512 frames with K6's device time summed over a
frame's launches. Every output (K1, K4-K8 and the frames) is hashed; the
parent process prints whether A's and B's hashes agree. The card's name
and power limit go with every number.

Tuning: --worker DIR NAME=VALUE ... runs a copy of DIR's package (in a
temporary directory; DIR is not touched) with each named constant set:
a `constexpr int NAME = ...;` of csrc/ or a module-level `NAME = ...` of
ops/cuda/, which must occur exactly once (for example kTraverseBlock=128
of csrc/bvh.cu, kPyramidMinBlocks=4 of csrc/conemarch.cu, or kBlockY=8
TILE_H=8 for the cone march's blocks and K1's mirrored tile).

Cone: the cone-march rows alone (ptxas of K1-K3, the 1920x1088 frame by
events with its enqueue, K1's and K2's device time a frame, the two-kernel
frame by events and K3's device time a frame from the finished depths,
hashes), for PAIRS pairs of runs in the order A B B A A B B A ..., each run
a process of its own; then each run's numbers side by side and in how many
pairs B's frame, enqueue, K1, K2, K3 and two-kernel frame time were below
A's. --cone-worker DIR [NAME=VALUE ...] is one such run. --k6-worker DIR
[NAME=VALUE ...] runs K6's rows alone (ptxas, the three ray sets, the
render_pt_fast(bvh=cs) frames), once.

Trips: K2's and K3's trip-count model. An instrumented copy of DIR's plain
march (ops/march.py, in a temporary directory; DIR is not touched) keeps each
pixel's step count of the finest level's cone march and of each light's
shadow march, over the orbit poses of the cone rows (at W x H and POSES if
given; on the card if there is one, else on the CPU); from them, the share
of a warp's lanes that do a useful step: in the primary march and in the
shadow marches run in the pixel's lane, for warps of 32 x 1, 8 x 4, 4 x 8
and 16 x 2 pixels, and in the shadow marches run as jobs compacted per warp
or per block of 128 or 256 pixels (each lit pixel's lights taken 32 at a
time, light-major: a form of K2 that was measured and not kept, PERF.md
§6), with each form's warp-steps a frame against the 32 x 1 warps that
march the shadow rays in the pixel's lane; and K3's: the shadow marches
alone, from the finished depth, against K3's parent's 32 x 1 warps.

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

Sass: every instantiation of K4, K5, K6 and K7 that both checkouts have
(K4's and K5's without the material features and with them, K6's without
and with UV planes, K7's), instruction for instruction. Each checkout's
libpt.so, libcluster.so and libinstanced.so are built by its own
ops/cuda/common.build (a process each) and read by cuobjdump -sass; each
instantiation of DIR_B is compared with DIR_A's of the same mesh kind and
template flags (pt_kernel<kind>, pt_rebin_kernel, cluster_kernel where
DIR_A has no material or UV one), with the addresses and encodings
dropped; instantiations DIR_A lacks are skipped.

Usage: python3 ab_config3.py DIR_A DIR_B
       python3 ab_config3.py --spheres DIR_A DIR_B
       python3 ab_config3.py --cone DIR_A DIR_B [PAIRS]   (default 10)
       python3 ab_config3.py --lanes DIR
       python3 ab_config3.py --bound5 DIR
       python3 ab_config3.py --sass DIR_A DIR_B
       python3 ab_config3.py --worker DIR [NAME=VALUE ...]   (one checkout, once)
       python3 ab_config3.py --sphere-worker DIR   (its sphere rows, once)
       python3 ab_config3.py --cone-worker DIR [NAME=VALUE ...]   (its cone rows, once)
       python3 ab_config3.py --k6-worker DIR [NAME=VALUE ...]   (its K6 rows, once)
       python3 ab_config3.py --trips DIR [W H POSES]
(each DIR holds a raytracing_engine_tpu_torch package, e.g. a `git archive`
of a commit unpacked into a gitignored directory)
"""

from __future__ import annotations

import difflib
import hashlib
import os
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
           "depth_kernel", "pyramid_kernel", "fused_kernel", "shade_kernel", "cluster_kernel",
           "pt_tex_kernel", "pt_rebin_tex_kernel", "instanced_uv_kernel")
K1_NAMES = ("depth_kernel", "pyramid_kernel")  # K1 before and after it took every level
CONE_NAMES = K1_NAMES + ("fused_kernel", "shade_kernel")
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
    a mesh kind is named pt_kernel<kind>, its material instantiation
    pt_kernel<kind, material> (K5's pt_rebin_kernel<material>), its texture
    instantiation pt_tex_kernel<kind>; other templates by their arguments
    (cluster_kernel<1, 1>)."""
    out, entry, stack = [], None, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = next((k for k in KERNELS if re.search(rf"\d{k}[EI]", m.group(1))), None)
            kind = re.search(r"\dpt(?:_tex)?_kernelILi(\d+)E", m.group(1))
            material = re.search(r"\dpt(?:_rebin)?_kernelI(?:Li\d+E)?Lb1E", m.group(1))
            targs = re.search(rf"\d{name}I((?:L[ib]\d+E)+)E", m.group(1)) if name else None
            if name and kind:
                name = f"{name}<{MESH_KINDS.get(int(kind.group(1)), kind.group(1))}"
                name += ", material>" if material else ">"
            elif name and material:
                name = f"{name}<material>"
            elif name and targs:
                name += "<" + ", ".join(re.findall(r"L[ib](\d+)E", targs.group(1))) + ">"
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
    return setup3(device), setup5(device)


def setup3(device):
    """Config 3 as chip_smoke.py builds it: cfg, scene, ClusterSet, mesh."""
    import numpy as np

    from raytracing_engine_tpu_torch.accel import build_clusters, torus_knot
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
    return dict(cfg=PTConfig(width=512, height=512, max_bounces=2, rng="pcg"), scene=scene,
                bvh=cs, mesh=mesh)


def setup5(device):
    """Config 5 as chip_smoke.py builds it."""
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
    return dict(cfg=PTConfig(width=512, height=512, max_bounces=2, rng="pcg"), scene=scene5,
                bvh=ic, cs=base, inst=inst, light=torch.tensor((6.0, 2.0, 8.0), device=device))


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


def best_frames(render, n: int):
    """(ms a frame by CUDA events, host enqueue ms a frame), best of ROUNDS
    rounds of render(k), k = 0..n-1, chained."""
    import torch

    best = None
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for k in range(n):
            render(k)
        host = (time.perf_counter() - t0) * 1e3 / n
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n
        if best is None or ms < best[0]:
            best = (ms, host)
    return best


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
    best = best_frames(lambda k: fn(c["cfg"], c["scene"], zs[k], quat, spp, **kw), n_frames)
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
    """The cone march at CONE_SIZE over the CONE_POSES orbit poses: the fused
    frame by CUDA events (best of ROUNDS, host enqueue beside), K1's device
    time a frame and by launch, K2's; the two-kernel frame
    (render(fused=False)) by events, and K3's device time a frame, from each
    pose's finished depth; the first pose's image, pyramid and K3 output
    hashed."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import cuda_renderer
    from raytracing_engine_tpu_torch.ops.cuda import shade

    cfg = rtt.RenderConfig(*CONE_SIZE)
    scene = rtt.default_scene(device)
    positions, rotations = orbit_path(CONE_POSES, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)
    poses = [(positions[k], quats[k]) for k in range(CONE_POSES)]

    def render(k, fused=True):
        return cuda_renderer.render(cfg, scene, *poses[k % CONE_POSES], fused=fused)

    img = render(0)
    levels = cuda_renderer.render_depth_pyramid(cfg, scene, *poses[0])
    depths = [cuda_renderer.render_depth_pyramid(cfg, scene, *pose)[-1] for pose in poses]

    def k3(k):
        return shade.shade(cfg, scene, *poses[k % CONE_POSES], depths[k % CONE_POSES])

    best = best_frames(render, CONE_POSES)
    two = best_frames(lambda k: render(k, fused=False), CONE_POSES)
    k1, places = device_sum_ms(render, CONE_POSES, K1_NAMES)
    k2, _ = device_sum_ms(render, CONE_POSES, ("fused_kernel",))
    k3_ms, _ = device_sum_ms(k3, CONE_POSES, ("shade_kernel",))
    size = f"{cfg.width}x{cfg.height}"
    print(f"  {root}: cone march {size} frame: best {best[0]:.4f} ms/frame (host enqueue "
          f"{best[1]:.4f} ms), K1 {k1:.4f} ms a frame (device time; {len(places)} launches a "
          f"frame: {' / '.join(f'{x:.4f}' for x in places)}), K2 {k2:.4f} ms a frame (device "
          f"time), image {digest(img)} [{card}]", flush=True)
    print(f"  {root}: cone march {size} pyramid: {len(levels)} levels, outputs "
          f"{digest(*levels)} [{card}]", flush=True)
    print(f"  {root}: cone march {size} two-kernel frame: best {two[0]:.4f} ms/frame (host "
          f"enqueue {two[1]:.4f} ms), K3 {k3_ms:.4f} ms a frame (device time, from the finished "
          f"depth), image {digest(render(0, fused=False))}, K3 outputs "
          f"{digest(*(k3(k) for k in range(CONE_POSES)))} [{card}]", flush=True)
    return best[0], best[1], k1, k2, k3_ms, two[0]


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


def k6_rows(root, card, device, c3, quat, seed):
    """K6 on config 3's ClusterSet: the camera, bounce-1 and NEE-style shadow
    rays of chip_smoke.py phase 10 (device time, outputs hashed; closest-hit
    sweeps with the frame's visit orders, as render_pt_fast makes them), and
    render_pt_fast(bvh=cs) frames with K6's device time summed a frame."""
    import torch

    from raytracing_engine_tpu_torch.ops.cuda import cluster as kcl
    from raytracing_engine_tpu_torch.ops.cuda import pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, uniform_pcg
    from raytracing_engine_tpu_torch.pathtracer.wavefront import _camera_rays, render_pt_fast

    cfg, scene, cs = c3["cfg"], c3["scene"], c3["bvh"]
    pos = torch.zeros(3, device=device)
    fc = kcl.FrameClusters.at(cs, pos)
    orders = dict(order=fc.orders[0], orders=fc.orders, refs=fc.refs)
    u = uniform_pcg(pass_seed(seed, 0), 0, 2, cfg.height, cfg.width, device=device)
    o0, d0 = (tuple(x.contiguous() for x in r) for r in _camera_rays(cfg, pos, quat, u[0], u[1]))
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, pos, quat, seed, cs)
    state, _ = run(0, None, 0)
    o1 = tuple(state[a].clone() for a in range(3))
    d1 = tuple(state[3 + a].clone() for a in range(3))
    light = torch.tensor(C3_LIGHT, device=device)
    to_l = tuple(light[a] - o1[a] for a in range(3))
    dist = torch.sqrt(to_l[0] * to_l[0] + to_l[1] * to_l[1] + to_l[2] * to_l[2])
    wi = tuple(c / dist for c in to_l)
    total = 0.0
    for label, o, d, t_max, kw in (
            ("camera rays, closest", o0, d0, float("inf"), orders),
            ("bounce-1 rays, closest", o1, d1, float("inf"), orders),
            ("bounce-1 NEE shadow rays, any hit", o1, wi, dist * 0.999,
             dict(any_hit=True, order=fc.orders[0]))):
        out = kcl.cluster_intersect(cs, o, d, t_max, **kw)
        ms = device_ms(lambda _, o=o, d=d, t_max=t_max, kw=kw: kcl.cluster_intersect(
            cs, o, d, t_max, **kw), K8_REPS, "cluster_kernel")
        total += ms
        print(f"  {root}: K6 config 3 ClusterSet {cfg.width}x{cfg.height} {label}: {ms:.4f} ms "
              f"(device time), outputs {digest(*out)} [{card}]", flush=True)
    print(f"  {root}: K6 config 3 ClusterSet: the three ray sets {total:.4f} ms [{card}]",
          flush=True)
    frames(root, card, "config 3 512x512 render_pt_fast(bvh=cs)", render_pt_fast,
           dict(cfg=cfg, scene=scene, bvh=cs), quat, seed, RAW_FRAMES, kernel="cluster_kernel",
           summed=True)


def k6_worker(root: str, settings=()) -> int:
    """K6's rows alone (ptxas, k6_rows), once."""
    path = variant(root, settings) if settings else Path(root).resolve()
    root = root + (f" [{' '.join(settings)}]" if settings else "")
    sys.path.insert(0, str(path))
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
        if name == "cluster_kernel":
            print(f"  {root}: ptxas {name}: {regs} registers, {stack} B stack, spill stores {st} "
                  f"B / loads {ld} B, {smem} B static smem", flush=True)
    k6_rows(root, card, device, setup3(device), torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
            seed_from_int(1))
    if settings:
        shutil.rmtree(path, ignore_errors=True)
    return 0


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
        if name in CONE_NAMES:
            print(f"  {root}: ptxas {name}: {regs} registers, {stack} B stack, spill stores {st} "
                  f"B / loads {ld} B, {smem} B static smem", flush=True)
    print(f"CONE {' '.join(str(x) for x in cone_rows(root, card, torch.device('cuda', 0)))}",
          flush=True)
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
            for m in re.finditer(r": (cone march .*?): (.*)", proc.stdout):
                for what, h in re.findall(r"(image|outputs) (\w{16})", m.group(2)):
                    hashes.setdefault((m.group(1), what), set()).add(h)
    for label, i in (("frame ms (events)", 0), ("host enqueue ms", 1), ("K1 ms a frame", 2),
                     ("K2 ms a frame", 3), ("K3 ms a frame", 4),
                     ("two-kernel frame ms (events)", 5)):
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
    k6_rows(root, card, device, c3, quat, seed)
    if settings:
        shutil.rmtree(path, ignore_errors=True)
    return 0


# --- K2's trip counts (--trips) ----------------------------------------------

# ops/march.py of the copy keeps, per call of cone_march / shadow_march, each
# pixel's step count (the plain loop's active lanes, summed per lane)
TRIP_PATCHES = [
    ('steps = {"march": 0, "shadow": 0}\n',
     'steps = {"march": 0, "shadow": 0}\ntrips = []\n'),
    ("    big = render_dist\n", "    big = render_dist\n    trips.append([\"march\", 0])\n"),
    ('    """\n    cache = scene_sdf_all(origin, obj_pos, obj_radius)\n',
     '    """\n    trips.append(["shadow", 0])\n'
     '    cache = scene_sdf_all(origin, obj_pos, obj_radius)\n'),
    ('        steps["march"] = steps["march"] + active.sum()\n',
     '        steps["march"] = steps["march"] + active.sum()\n'
     '        trips[-1][1] = trips[-1][1] + active.to(torch.int32)\n'),
    ('        steps["shadow"] = steps["shadow"] + active.sum()\n',
     '        steps["shadow"] = steps["shadow"] + active.sum()\n'
     '        trips[-1][1] = trips[-1][1] + active.to(torch.int32)\n'),
]
# warp tiles (w x h) the model compares, and for each the blocks of warp
# tiles (wx x wy) whose shadow jobs it compacts
TRIP_WARPS = ((32, 1), (8, 4), (4, 8), (16, 2))
TRIP_BLOCKS = {(32, 1): ((1, 4), (1, 8)), (8, 4): ((2, 2), (4, 2)), (4, 8): ((2, 2), (4, 2)),
               (16, 2): ((2, 2), (4, 2))}


def tiles(a, tw: int, th: int):
    """(..., H, W) -> (..., tiles, tw * th): row-major tiles of th x tw
    pixels, each tile's pixels in row-major (lane) order."""
    *lead, h, w = a.shape
    a = a.reshape(*lead, h // th, th, w // tw, tw)
    a = a.swapaxes(-3, -2)
    return a.reshape(*lead, (h // th) * (w // tw), th * tw)


def block_lanes(a, warp, blk):
    """(..., H, W) -> (..., blocks, pixels): a block of blk[0] x blk[1] warp
    tiles, its pixels in thread order (warp-major, each warp's lanes
    row-major), as csrc/conemarch.cu lays out fused_kernel's block."""
    (ww, wh), (bx, by) = warp, blk
    *lead, h, w = a.shape
    a = a.reshape(*lead, h // (wh * by), by, wh, w // (ww * bx), bx, ww)
    n = len(lead)
    a = a.transpose(*range(n), n, n + 3, n + 1, n + 4, n + 2, n + 5)
    return a.reshape(*lead, (h // (wh * by)) * (w // (ww * bx)), by * bx * wh * ww)


def warp_steps(steps):
    """Warp-steps of lanes that run in lockstep: (..., groups, 32) -> the sum
    over groups of 32 x the group's longest count."""
    return 32 * int(steps.max(axis=-1).sum())


def job_steps(shadow, lit):
    """Warp-steps of the shadow marches run as jobs compacted per group (a
    warp or a block): shadow (L, groups, P) counts, lit (groups, P); each
    group's lit pixels in thread order post one job a light, light-major,
    taken 32 at a time."""
    import numpy as np

    n_light, groups, p = shadow.shape
    order = np.argsort(~lit, axis=1, kind="stable")  # lit pixels first, in order
    s = np.take_along_axis(shadow, order[None], axis=2)  # (L, G, P)
    n_lit = lit.sum(axis=1)
    keep = np.broadcast_to(np.arange(p)[None, :] < n_lit[:, None], (n_light, groups, p))
    jobs = s.transpose(1, 0, 2)[keep.transpose(1, 0, 2)]  # group-major, light-major
    per = n_lit * n_light  # jobs of each group
    rounds = (per + 31) // 32
    if jobs.size == 0:
        return 0, int(rounds.sum())
    first = np.cumsum(per) - per
    group = np.repeat(np.arange(groups), rounds)
    within = np.arange(int(rounds.sum())) - np.repeat(np.cumsum(rounds) - rounds, rounds)
    starts = first[group] + 32 * within
    return 32 * int(np.maximum.reduceat(jobs, starts).sum()), int(rounds.sum())


def trips(root: str, size=CONE_SIZE, poses=CONE_POSES) -> int:
    """K2's trip-count model (see the module docstring)."""
    tmp = Path(tempfile.mkdtemp(prefix="ab_trips_"))
    pkg = tmp / "raytracing_engine_tpu_torch"
    shutil.copytree(Path(root) / "raytracing_engine_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = pkg / "ops" / "march.py"
    src = path.read_text()
    for old, new in TRIP_PATCHES:
        if src.count(old) != 1:
            print(f"ab_config3 --trips: {root}: ops/march.py has no {old.strip()[:40]!r}",
                  file=sys.stderr)
            return 1
        src = src.replace(old, new)
    path.write_text(src)
    sys.path.insert(0, str(tmp))
    import numpy as np
    import torch

    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.ops import march
    from raytracing_engine_tpu_torch.ops.cuda import depth as kdepth
    from raytracing_engine_tpu_torch.ops.cuda import shade as kshade

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    where = card_line() if device.type == "cuda" else "the plain march on the CPU"
    cfg = rtt.RenderConfig(*size)
    scene = rtt.default_scene(device)
    n_light = int(scene.light_count)
    positions, rotations = orbit_path(poses, radius=16.0)
    quats = Camera(positions, rotations).quat().to(device)
    positions = positions.to(device)
    last = cfg.level_count - 1
    prim, shad, lit = [], [], []
    for k in range(poses):
        pose = (positions[k], quats[k])
        prev = kdepth.march_levels_reference(cfg, 0, last - 1, scene, *pose)[-1]
        march.trips.clear()
        dep = kdepth.depth_level_reference(cfg, last, scene, *pose, prev)
        kshade.shade_reference(cfg, scene, *pose, dep)
        kinds = [kind for kind, _ in march.trips]
        if kinds != ["march"] + ["shadow"] * 8:
            raise RuntimeError(f"ab_config3 --trips: unexpected march calls {kinds}")

        def host(x):
            return (x if isinstance(x, torch.Tensor) else torch.zeros_like(dep, dtype=torch.int32)
                    ).cpu().numpy().astype(np.int64)

        prim.append(host(march.trips[0][1]))
        shad.append(np.stack([host(c) for _, c in march.trips[1:1 + n_light]]))
        lit.append((dep < cfg.render_dist).cpu().numpy())
    prim, shad, lit = np.stack(prim), np.stack(shad, axis=1), np.stack(lit)  # shad (L, F, H, W)
    p_steps, s_steps = int(prim.sum()), int(shad.sum())
    print(f"  {root}: K2 trips {cfg.width}x{cfg.height}, {poses} orbit poses, {n_light} lights: "
          f"lit pixels {lit.mean():.4f}; steps a frame: primary {p_steps / poses:.0f} "
          f"({prim.mean():.2f} a pixel, max {prim.max()}), shadow {s_steps / poses:.0f} "
          f"({shad.sum(0)[lit].mean():.2f} a lit pixel over its lights, max "
          f"{shad.max()}) [{where}]", flush=True)
    base = s_base = None
    for warp in TRIP_WARPS:
        ww, wh = warp
        p_warp = warp_steps(tiles(prim, ww, wh))
        s_lane = warp_steps(tiles(shad, ww, wh))
        s_jobs, _ = job_steps(tiles(shad, ww, wh).reshape(n_light, -1, 32),
                              tiles(lit, ww, wh).reshape(-1, 32))
        if base is None:
            base, s_base = p_warp + s_lane, s_lane
        parts = [f"primary {p_steps / p_warp:.3f}", f"shadow in the pixel's lane "
                 f"{s_steps / s_lane:.3f}", f"shadow jobs a warp {s_steps / max(s_jobs, 1):.3f}"]
        model = [f"in-lane {(p_warp + s_lane) / base:.3f}", f"warp list "
                 f"{(p_warp + s_jobs) / base:.3f}"]
        for blk in TRIP_BLOCKS[warp]:
            n_pix = 32 * blk[0] * blk[1]
            b_jobs, _ = job_steps(block_lanes(shad, warp, blk).reshape(n_light, -1, n_pix),
                                  block_lanes(lit, warp, blk).reshape(-1, n_pix))
            parts.append(f"shadow jobs a {n_pix}-pixel block ({blk[0]} x {blk[1]} warps) "
                         f"{s_steps / max(b_jobs, 1):.3f}")
            model.append(f"{n_pix}-pixel list {(p_warp + b_jobs) / base:.3f}")
        print(f"  {root}: K2 trips, {ww} x {wh} warps: share of lanes doing useful steps: "
              f"{'; '.join(parts)}. Warp-steps a frame against 32 x 1 warps marching in the "
              f"pixel's lane: {'; '.join(model)} [{where}]", flush=True)
        print(f"  {root}: K3 trips, {ww} x {wh} warps (the shadow march alone, from the finished "
              f"depth): share of lanes doing useful steps {s_steps / s_lane:.3f}; shadow "
              f"warp-steps a frame {s_lane / poses:.0f}, {s_lane / s_base:.3f} of 32 x 1 warps' "
              f"[{where}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
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
    # K5's bytes from the live rays of each bounce's state, as chip_smoke.py
    # counts them (k5_states, live_rays)
    _, _, run = pt.rebin_bounce_launcher(cfg, scene, cam, quat, seed, ic)
    modes = pt._gap_modes("none,morton")
    live = []
    st, _ = run(0, None, 0)
    for b in range(1, cfg.max_bounces + 1):
        st = pt.regroup(st, modes[min(b - 1, len(modes) - 1)])
        live.append(int((st[0].abs() < cluster.PARKED).sum()))
        st, _ = run(b, st, 0)
    n_bytes = k5_bytes(cfg.width * cfg.height, live, tables)
    bound = bound_ms(n_bytes, ops)
    print(f"  {root}: K5 config 5 {cfg.width}x{cfg.height} frame: the plain rebin render of the "
          f"whole frame == K4's bit for bit: {same} (plain {plain_s:.1f} s); work "
          f"{kinst.work['gates']} instance gates, {kinst.work['transforms']} transforms, "
          f"{cluster.work['slabs']} box + {cluster.work['tests']} triangle tests, {int(n)} rays "
          f"x {int(scene.sph_count)} spheres -> bound {bound[0]:.5f} ms by {bound[1]} "
          f"({n_bytes} B: live rays by bounce {live}; {ops} ops) [{card}]", flush=True)
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


# --- the SASS of K4 and K5 (--sass) -------------------------------------------

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from raytracing_engine_tpu_torch.ops.cuda import common; common.build()")


def sass_functions(lib: Path, kernels=("pt_kernel", "pt_rebin_kernel", "pt_tex_kernel",
                                       "pt_rebin_tex_kernel", "pt_samp_kernel",
                                       "pt_samp_tex_kernel", "pt_rebin_samp_kernel",
                                       "pt_rebin_samp_tex_kernel", "pt_cell_kernel")) -> dict:
    """{(kernel, mesh kind or None, its bool template arguments, "0" where
    it has none): [instruction, ...]} of the functions named `kernels` in
    lib, from cuobjdump -sass, without the addresses and encodings. The
    instantiations without features have the flags "0"; K6's tangent
    overload cluster_kernel<true, true> is "11"."""
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, key = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"\d(" + "|".join(kernels) + r")(?:I(?:Li(\d+)E)?((?:Lb\dE)*)E)?",
                          m.group(1))
            flags = "".join(re.findall(r"Lb(\d)E", k.group(3) or "")) if k else ""
            key = (k.group(1), k.group(2), flags or "0") if k else None
            if key is not None:
                out[key] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if key is not None and ins:
            out[key].append(" ".join(ins.group(1).split()))
    return out


def sass(a: str, b: str) -> int:
    card = card_line()
    funcs = {}
    for root in (a, b):
        path = Path(root).resolve()
        subprocess.run([sys.executable, "-c", BUILD, str(path)], check=True, timeout=900)
        build = path / "raytracing_engine_tpu_torch" / "build"
        funcs[root] = {**sass_functions(build / "libpt.so"),
                       **sass_functions(build / "libcluster.so", ("cluster_kernel",)),
                       **sass_functions(build / "libinstanced.so", ("instanced_kernel",))}
        print(f"  {root}: {sorted(funcs[root])}", flush=True)
    same = {}
    for key in sorted(k for k in funcs[b] if k in funcs[a]):  # every instantiation A has
        ia, ib = funcs[a][key], funcs[b][key]
        diff = [d for d in difflib.unified_diff(ia, ib, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        name = key[0] + "<" + ", ".join(
            ([MESH_KINDS.get(int(key[1]), key[1])] if key[1] else []) + [key[2]]) + ">"
        same[name] = not diff
        if diff:  # the whole diff, with context, beside the log
            Path("smoke_out").mkdir(exist_ok=True)
            Path(f"smoke_out/sass_{key[0]}_{key[1]}_{key[2]}.diff").write_text("\n".join(
                difflib.unified_diff(ia, ib, "A", "B", lineterm="", n=6)))
        print(f"  {name}: {len(ia)} instructions at A, {len(ib)} at B, {len(diff)} lines "
              f"differ{': ' + ' | '.join(diff[:12]) if diff else ''} [{card}]", flush=True)
    print(f"every instantiation of K4, K5, K6 and K7 that A has (the flags after the mesh kind: "
          f"0 none, 1 material or UV planes) is the same SASS at B: "
          f"{all(same.values()) and bool(same)} {same}", flush=True)
    return 0 if same and all(same.values()) else 1


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2], sys.argv[3:])
    if len(sys.argv) == 3 and sys.argv[1] == "--lanes":
        return lanes(sys.argv[2])
    if len(sys.argv) in (3, 6) and sys.argv[1] == "--trips":
        extra = [int(x) for x in sys.argv[3:]]
        return trips(sys.argv[2], *((tuple(extra[:2]), extra[2]) if extra else ()))
    if len(sys.argv) == 4 and sys.argv[1] == "--sass":
        return sass(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 3 and sys.argv[1] == "--bound5":
        return bound5(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphere-worker":
        return sphere_worker(sys.argv[2])
    if len(sys.argv) >= 3 and sys.argv[1] == "--k6-worker":
        return k6_worker(sys.argv[2], sys.argv[3:])
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
