#!/usr/bin/env python3
"""Config 3's mesh path at two checkouts of the port, on one GPU.

For checkout A, B, B, A in turn, each in a process of its own: builds the
checkout's kernels from its csrc/ (into its own build directory) and prints
ptxas's registers and stack of pt_kernel (K4) and pt_rebin_kernel (K5), then
times BASELINE config 3 (benchmarks/run_all.py:120-148: the 70,400-triangle
torus knot as a ClusterSet, 512x512, 2 bounces, 1 spp, pcg, seed_from_int(1))
through render_pt_mega(bvh=cs) and render_pt_rebin(bvh=cs): best of 3 rounds
of 8 chained frames with distinct camera z, by CUDA events, host enqueue
beside. The card's name and power limit go with every number.

Usage: python3 ab_config3.py DIR_A DIR_B
(each DIR holds a raytracing_engine_tpu_torch package, e.g. a `git archive`
of a commit unpacked into a gitignored directory)
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

FRAMES, ROUNDS = 8, 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def worker(root: str) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from raytracing_engine_tpu_torch.accel import build_clusters, torus_knot
    from raytracing_engine_tpu_torch.ops.cuda import common, pt
    from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
    from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene

    if not torch.cuda.is_available():
        print("ab_config3: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    info = common.build()
    entry = None
    for line in info["log"].splitlines():
        if "entry function" in line and "pt" in line:
            entry = line.split("'")[1]
        elif entry and "registers" in line:
            print(f"  {root}: {entry}: {line.split(':', 1)[1].strip()}", flush=True)
            entry = None

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    mats_t = np.zeros(mesh.shape[0], np.int32)
    cs = build_clusters(mesh, tri_mats=mats_t, device=device)
    scene = build_pt_scene(
        spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
        triangles=mesh, tri_mats=mats_t, device=device,
        materials=[{"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
                   {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}])
    cfg = PTConfig(width=512, height=512, max_bounces=2, rng="pcg")
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    seed = seed_from_int(1)
    zs = [torch.tensor([0.0, 0.0, 1e-4 * k], device=device) for k in range(FRAMES)]
    for name, fn in (("render_pt_mega(bvh=cs)", pt.render_pt_mega),
                     ("render_pt_rebin(bvh=cs)", pt.render_pt_rebin)):
        fn(cfg, scene, zs[0], quat, 1, seed=seed, bvh=cs)  # warm-up
        best = None
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for k in range(FRAMES):
                fn(cfg, scene, zs[k], quat, 1, seed=seed, bvh=cs)
            host = (time.perf_counter() - t0) * 1e3 / FRAMES
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / FRAMES
            if best is None or ms < best[0]:
                best = (ms, host)
        print(f"  {root}: config 3 512x512 {name}: best {best[0]:.4f} ms/frame (host enqueue "
              f"{best[1]:.4f} ms) [{card}]", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2])
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for root in (a, b, b, a):
        rc = subprocess.run([sys.executable, __file__, "--worker", root], timeout=600).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
