"""Command-line frame server: render scenes headlessly to PNGs
(raytracing_engine_tpu/cli.py).

Scripted camera paths instead of WASD/mouse, PNG frames instead of a
swapchain. The JAX package's subcommands, options, choices and defaults,
plus one option on each: ``--device`` (default ``cuda``). Every tensor of a
run is built on that device; without CUDA the default raises
(device.resolve) and nothing falls back to the CPU. ``--device cpu`` runs
the kernels' plain PyTorch versions.

Usage:
    python -m raytracing_engine_tpu_torch.cli render  --size 512x512 --out out/
    python -m raytracing_engine_tpu_torch.cli orbit   --frames 60 --out orbit/
    python -m raytracing_engine_tpu_torch.cli pt      --scene cornell --spp 64
    python -m raytracing_engine_tpu_torch.cli pt      --scene knot --spp 16 --bvh

Routes, with the JAX package's meanings:
- ``render --engine pallas`` is the hand-written kernels
  (models/cuda_renderer.render: K1, K2), ``jnp`` the plain renderer
  (models/conemarch.render); ``orbit`` and ``replay`` take the kernels.
- ``pt --engine fast|mega|rebin`` are pathtracer.render_pt_fast and
  ops/cuda/pt.render_pt_mega (K4) and render_pt_rebin (K5); ``--rng
  pallas`` is K9's stream. ``auto`` picks rebin for a ClusterSet or an
  InstancedClusters (mega with ``--adaptive``), fast otherwise; rebin
  drops ``--adaptive``, a defect of the reference copied here.
- ``pt --bvh`` on a mesh: the JAX package builds a ClusterSet on the TPU
  (or for ``--engine mega|rebin``) and a skip-link BVH elsewhere. Here the
  device takes the backend's place: a ClusterSet on ``cuda`` (so ``auto``
  renders a mesh through K5) or for ``--engine mega|rebin``, a skip-link
  BVH (K8 on the card) on the CPU, the JAX package's route off the TPU.
- ``instanced`` renders models/instanced.render_instanced_phong (K7).

``--aperture`` / ``--focus`` (the thin lens), ``--sampler r2`` (R_d, at
``--rng pcg``) and ``--adaptive TOL`` on mega render as in the JAX package.
Features the port does not have yet (``--fog``, mesh lights) raise the
renderers' own NotImplementedError, which names its ROADMAP item. Printed
times wait for the device first.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from raytracing_engine_tpu_torch.device import resolve
from raytracing_engine_tpu_torch.runtime.frame import _wait


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def cmd_render(args):
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
    from raytracing_engine_tpu_torch.utils import write_png

    dev = resolve(args.device)
    w, h = _parse_size(args.size)
    cfg = rtt.RenderConfig(width=w, height=h)
    scene = rtt.default_scene(dev)
    cam = rtt.Camera.initial()
    render = conemarch.render if args.engine == "jnp" else cuda_renderer.render
    t0 = time.perf_counter()
    img = render(cfg, scene, cam.position.to(dev), cam.quat().to(dev))
    _wait(img)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "frame_0000.png")
    write_png(path, img.cpu().numpy())
    print(f"{path}  ({time.perf_counter()-t0:.1f}s incl. kernel build)")


def cmd_orbit(args):
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.camera import Camera, orbit_path
    from raytracing_engine_tpu_torch.models import cuda_renderer
    from raytracing_engine_tpu_torch.utils import write_png
    from raytracing_engine_tpu_torch.utils.timing import FrameStats, conemarch_ray_count

    dev = resolve(args.device)
    w, h = _parse_size(args.size)
    cfg = rtt.RenderConfig(width=w, height=h)
    scene = rtt.default_scene(dev)
    positions, rotations = orbit_path(args.frames)
    # --resume (PNG-dir sink only): skip frames whose file already exists.
    # Orbit poses are a pure function of the frame index, so a resumed run
    # produces bit-identical frames to an uninterrupted one.
    todo = list(range(args.frames))
    if args.resume and not (args.y4m or args.apng):
        todo = [i for i in todo
                if not os.path.exists(os.path.join(args.out, f"frame_{i:04d}.png"))]
        print(f"resume: {args.frames - len(todo)} frames already on disk, "
              f"{len(todo)} to render")
    writer = None
    if args.y4m:
        from raytracing_engine_tpu_torch.utils.video import VideoWriter

        writer = VideoWriter(args.y4m, fps=args.fps)
    elif args.apng:
        from raytracing_engine_tpu_torch.utils.video import ApngWriter

        writer = ApngWriter(args.apng, fps=args.fps)
    else:
        os.makedirs(args.out, exist_ok=True)
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    n_obj, n_light = int(scene.obj_count), int(scene.light_count)
    cams = [Camera(position=positions[i], rotation=rotations[i]) for i in todo]
    if args.chunk > 1:
        # K frames per sequence (runtime/serve.py), one copy to the host a chunk
        from raytracing_engine_tpu_torch.runtime import render_sequence

        def fn(cfg, scene, pos, quat):
            return cuda_renderer.render(cfg, scene, pos, quat, n_obj=n_obj, n_light=n_light)

        P = torch.stack([c.position for c in cams]) if cams else torch.zeros((0, 3))
        Q = torch.stack([c.quat() for c in cams]) if cams else torch.zeros((0, 4))
        for k0 in range(0, len(todo), args.chunk):
            k1 = min(k0 + args.chunk, len(todo))
            t0 = time.perf_counter()
            frames = render_sequence(cfg, scene, P[k0:k1], Q[k0:k1], fn=fn)
            frames = frames.permute(0, 2, 3, 1).cpu().numpy()  # waits for the chunk
            dt = (time.perf_counter() - t0) / (k1 - k0)
            st = FrameStats(primary, secondary, dt)
            for i, img in zip(todo[k0:k1], frames):
                if writer is not None:
                    writer.add(img)
                else:
                    write_png(os.path.join(args.out, f"frame_{i:04d}.png"), img)
            print(f"frames {todo[k0]:3d}-{todo[k1-1]:3d}: "
                  f"{st.seconds*1e3:7.2f} ms/frame "
                  f"{st.mrays_per_sec:8.1f} Mrays/s (chunked dispatch)")
    else:
        for i, cam in zip(todo, cams):
            t0 = time.perf_counter()
            img = cuda_renderer.render(cfg, scene, cam.position.to(dev), cam.quat().to(dev),
                                       n_obj=n_obj, n_light=n_light)
            _wait(img)
            st = FrameStats(primary, secondary, time.perf_counter() - t0)
            if writer is not None:
                writer.add(img.cpu().numpy())
            else:
                write_png(os.path.join(args.out, f"frame_{i:04d}.png"), img.cpu().numpy())
            print(f"frame {i:3d}: {st.seconds*1e3:7.2f} ms  {st.mrays_per_sec:8.1f} Mrays/s")
    if writer is not None:
        writer.close()
        print(f"{args.y4m or args.apng}: {writer.frames} frames @ {args.fps} fps")


def cmd_replay(args):
    """Play a recorded input stream through the frame loop (deterministic:
    same replay file -> bit-identical frames; see runtime/replay.py)."""
    import raytracing_engine_tpu_torch as rtt
    from raytracing_engine_tpu_torch.runtime import FrameLoop, load_replay
    from raytracing_engine_tpu_torch.utils import write_png

    dev = resolve(args.device)
    w, h = _parse_size(args.size)
    cfg = rtt.RenderConfig(width=w, height=h)
    scene = rtt.default_scene(dev)
    loop = FrameLoop(cfg, scene, monitor=_parse_size(args.monitor))
    events = load_replay(args.replay)

    writer = None
    if args.y4m or args.apng:
        if args.y4m:
            from raytracing_engine_tpu_torch.utils.video import VideoWriter

            writer = VideoWriter(args.y4m, fps=args.fps)
        else:
            from raytracing_engine_tpu_torch.utils.video import ApngWriter

            writer = ApngWriter(args.apng, fps=args.fps)

        def sink(i, img):
            writer.add(img)
    else:
        os.makedirs(args.out, exist_ok=True)

        def sink(i, img):
            write_png(os.path.join(args.out, f"frame_{i:04d}.png"), img)

    # FrameLoop's stats wait for each frame (or chunk) before reading the clock
    stats = loop.run(events, sink=sink, stats=True,
                     chunk=args.chunk if args.chunk > 1 else None)
    if writer is not None:
        writer.close()
    n = len(stats)
    if n:
        ms = sum(s.seconds for s in stats) / n * 1e3
        print(f"{n} frames replayed, {ms:.2f} ms/frame avg")
    else:
        print("0 frames replayed")


def _pt_orbit(args, cfg, scene, bvh, key, dev):
    """Path-traced camera orbit: N low-spp frames around --orbit-target,
    optionally temporal-reprojection accumulated (--temporal: each frame
    inherits the history of the previous poses) and tonemapped; sink =
    --apng or a PNG directory (--out)."""
    from raytracing_engine_tpu_torch.camera import orbit_path
    from raytracing_engine_tpu_torch.ops.quaternion import (
        quat_from_rotation_x,
        quat_from_rotation_z,
        quat_mul,
    )
    from raytracing_engine_tpu_torch.ops.rng import fold_in
    from raytracing_engine_tpu_torch.pathtracer import render_pt_fast
    from raytracing_engine_tpu_torch.utils import tonemap, write_png

    positions, rotations = orbit_path(
        args.orbit, radius=args.orbit_radius, height=args.orbit_height,
        target=tuple(args.orbit_target))
    engine = _resolve_pt_engine(args, bvh)
    if engine in ("mega", "rebin"):
        from raytracing_engine_tpu_torch.ops.cuda.pt import render_pt_mega, render_pt_rebin

        cfg = dataclasses.replace(cfg, rng="pcg")
        if engine == "rebin" and bvh is None:
            raise SystemExit("--engine rebin needs a mesh scene with --bvh")

    tstate = None
    if args.temporal:
        from raytracing_engine_tpu_torch.pathtracer import (
            render_aovs,
            temporal_init,
            temporal_step,
        )

        tstate = temporal_init(cfg, device=dev)

    writer = None
    if args.apng:
        from raytracing_engine_tpu_torch.utils.video import ApngWriter

        writer = ApngWriter(args.apng, fps=args.fps)
    else:
        os.makedirs(args.out or "pt_orbit", exist_ok=True)

    t0 = time.perf_counter()
    for i in range(args.orbit):
        yaw, pitch = rotations[i][0], rotations[i][1]
        quat = quat_mul(quat_from_rotation_z(-yaw), quat_from_rotation_x(pitch)).to(dev)
        pos = positions[i].to(dev)
        fkey = fold_in(key, i)
        if engine == "rebin":
            img, _ = render_pt_rebin(cfg, scene, pos, quat, args.spp, fkey, bvh=bvh)
        elif engine == "mega":
            img, _ = render_pt_mega(cfg, scene, pos, quat, args.spp, fkey, bvh=bvh,
                                    adaptive_tol=args.adaptive)
        else:
            img, _ = render_pt_fast(cfg, scene, pos, quat, args.spp, fkey, bvh=bvh)
        if args.temporal:
            aovs = render_aovs(cfg, scene, pos, quat, min(args.spp, 8), fkey, bvh=bvh)
            tstate, img = temporal_step(cfg, tstate, img, aovs, pos, quat)
        frame = img.cpu().numpy()  # waits for the frame
        if args.tonemap != "none" or args.exposure != 1.0 or args.gamma != 1.0:
            frame = tonemap(frame, args.tonemap, args.exposure, args.gamma)
        if writer is not None:
            writer.add(frame)
        else:
            write_png(os.path.join(args.out or "pt_orbit", f"frame_{i:04d}.png"), frame)
        if i % 8 == 0:
            print(f"  frame {i}/{args.orbit}")
    if writer is not None:
        writer.close()
        sink = args.apng
    else:
        sink = args.out or "pt_orbit"
    dt = time.perf_counter() - t0
    print(f"{sink}  {args.orbit} frames in {dt:.1f}s "
          f"({dt / args.orbit * 1e3:.0f} ms/frame"
          + (", temporal" if args.temporal else "") + ")")


def _resolve_pt_engine(args, bvh):
    """Map --engine (+ the legacy --mega alias) to an execution path.

    auto = the fastest engine the scene supports: rebin when cluster
    tables are present (per-bounce launches with a regroup between them),
    fast otherwise, with --adaptive staying on mega (per-tile stopping is a
    megakernel feature). As in the reference, the binary runs the fast
    path and flags only override it."""
    engine = getattr(args, "engine", "auto")
    if getattr(args, "mega", False) and engine == "auto":
        engine = "mega"
    if engine != "auto":
        return engine
    from raytracing_engine_tpu_torch.accel import ClusterSet, InstancedClusters

    if isinstance(bvh, (ClusterSet, InstancedClusters)):
        return "mega" if args.adaptive else "rebin"
    return "fast"


def _wants_clusters(args, dev) -> bool:
    """A mesh's --bvh container: a ClusterSet on the card or for the
    megakernels, else a skip-link BVH (the module docstring's route rule)."""
    return dev.type == "cuda" or args.engine in ("mega", "rebin")


def cmd_pt(args):
    from raytracing_engine_tpu_torch.pathtracer import PTConfig, render_pt_fast
    from raytracing_engine_tpu_torch.pathtracer import scenes as pt_scenes
    from raytracing_engine_tpu_torch.utils import write_png

    dev = resolve(args.device)
    w, h = _parse_size(args.size)
    cfg = PTConfig(width=w, height=h, max_bounces=args.bounces, rng=args.rng,
                   aperture=args.aperture, focus_dist=args.focus,
                   rr_start=args.rr, sampler=args.sampler,
                   fog_density=args.fog, fog_color=tuple(args.fog_color),
                   tex_filter=args.tex_filter)
    bvh = None
    origin = torch.zeros(3, device=dev)
    identity = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    if args.scene.endswith(".json"):
        # declarative scene file (pathtracer/sceneio.py schema)
        from raytracing_engine_tpu_torch.pathtracer.sceneio import load_scene_json

        b = load_scene_json(args.scene, device=dev)
        scene, mesh, tri_mats = b.scene, b.tris, b.tri_mats
        instanced, tri_normals = b.instanced, b.tri_normals
        pos = torch.from_numpy(b.cam_pos).to(dev)
        quat = torch.from_numpy(b.cam_quat).to(dev)
        if mesh is not None:
            print(f"{args.scene}: {mesh.shape[0]} triangles"
                  + (" (smooth)" if tri_normals is not None else ""))
            if args.bvh:
                from raytracing_engine_tpu_torch.accel import build_bvh, build_clusters

                bvh = (build_clusters(mesh, tri_mats=tri_mats, vertex_normals=tri_normals,
                                      vertex_uvs=b.tri_uvs, device=dev)
                       if _wants_clusters(args, dev) else build_bvh(mesh, device=dev))
        if instanced is not None:
            from raytracing_engine_tpu_torch.accel import (
                build_bvh,
                build_clusters,
                make_instanced_clusters,
                make_instances,
            )

            n_inst = len(instanced["transforms"])
            print(f"{args.scene}: {instanced['mesh'].shape[0]} tris x "
                  f"{n_inst} instances (two-level)")
            bvh_i = build_bvh(instanced["mesh"], device=dev)
            cs_i = build_clusters(
                instanced["mesh"], bvh=bvh_i,
                tri_mats=np.full(instanced["mesh"].shape[0], instanced["mat"], np.int32),
                vertex_uvs=instanced.get("uvs"), device=dev)
            inst = make_instances(bvh_i, instanced["transforms"],
                                  mats=np.full(n_inst, instanced["mat"], np.int32), device=dev)
            bvh = make_instanced_clusters(inst, cs_i, scene=scene, device=dev)
    elif args.scene in ("cornell", "glass"):
        scene = pt_scenes.cornell_box(glass=args.scene == "glass", device=dev)
        pos, quat = torch.tensor([0.0, 0.2, 0.0], device=dev), identity
    elif args.scene == "spheres":
        scene = pt_scenes.material_spheres(device=dev)
        pos, quat = origin, identity
    elif args.scene in ("knot", "obj"):
        from raytracing_engine_tpu_torch.accel import (
            build_bvh,
            build_clusters,
            load_obj,
            smooth_vertex_normals,
            torus_knot,
        )
        from raytracing_engine_tpu_torch.pathtracer.scene import DIFFUSE, build_pt_scene

        vnorms = None
        if args.scene == "obj":
            if not args.mesh:
                raise SystemExit("--scene obj requires --mesh FILE.obj")
            if args.smooth:
                mesh, vnorms = load_obj(args.mesh, normals=True)
            else:
                mesh = load_obj(args.mesh)
            print(f"{args.mesh}: {mesh.shape[0]} triangles")
        else:
            mesh = torus_knot(segments=args.segments, sides=32, center=(0.0, 8.0, 0.0))
        if args.smooth and vnorms is None:
            vnorms = smooth_vertex_normals(mesh)
        mats = [
            {"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (10.0, 10.0, 10.0), "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
        ]
        scene = build_pt_scene(
            spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
            triangles=mesh,
            tri_mats=np.zeros(mesh.shape[0], np.int32),
            materials=mats,
            device=dev,
        )
        if args.bvh:
            bvh = (build_clusters(mesh, tri_mats=np.zeros(mesh.shape[0], np.int32),
                                  vertex_normals=vnorms, device=dev)
                   if _wants_clusters(args, dev) else build_bvh(mesh, device=dev))
        pos, quat = origin, identity
    else:
        raise SystemExit(f"unknown scene {args.scene}")

    # jax.random.PRNGKey(seed)'s key data: the renderers fold it in (threefry,
    # pallas) or derive the pcg base seed from it, as the JAX package does
    from raytracing_engine_tpu_torch.ops.rng_pcg import prng_key_data

    key = prng_key_data(args.seed)
    t0 = time.perf_counter()
    if args.orbit:
        return _pt_orbit(args, cfg, scene, bvh, key, dev)
    if args.checkpoint:
        from raytracing_engine_tpu_torch.runtime.checkpoint import (
            ProgressiveState,
            load_checkpoint,
            progressive_render,
        )

        if os.path.exists(args.checkpoint) and not args.fresh:
            state = load_checkpoint(args.checkpoint, device=dev)
            print(f"resuming at {state.spp_done} spp")
        else:
            state = ProgressiveState.start(cfg, pos, quat, key=args.seed, device=dev)
        for state in progressive_render(cfg, scene, state, args.spp,
                                        bvh=bvh, checkpoint_path=args.checkpoint):
            print(f"  {state.spp_done}/{args.spp} spp")
        img = state.image  # the host copy waits for the last chunk
        nrays = float("nan")
    else:
        engine = _resolve_pt_engine(args, bvh)
        if engine in ("mega", "rebin"):
            from raytracing_engine_tpu_torch.accel import ClusterSet, InstancedClusters
            from raytracing_engine_tpu_torch.ops.cuda.pt import render_pt_mega, render_pt_rebin

            if bvh is not None and not isinstance(bvh, (ClusterSet, InstancedClusters)):
                raise SystemExit(f"--engine {engine} needs a ClusterSet")
            pcg = dataclasses.replace(cfg, rng="pcg")
            if engine == "rebin":
                if bvh is None:
                    raise SystemExit(
                        "--engine rebin needs a mesh scene with --bvh "
                        "(the per-bounce regroup runs over cluster tables)")
                img, nrays = render_pt_rebin(pcg, scene, pos, quat, args.spp, key, bvh=bvh)
            else:
                img, nrays = render_pt_mega(pcg, scene, pos, quat, args.spp, key, bvh=bvh,
                                            adaptive_tol=args.adaptive)
        else:
            img, nrays = render_pt_fast(cfg, scene, pos, quat, args.spp, key, bvh=bvh)
        img = img.cpu().numpy()  # waits for the render
    dt = time.perf_counter() - t0
    out = args.out or f"{args.scene}_{args.spp}spp.png"
    if args.denoise:
        from raytracing_engine_tpu_torch.pathtracer import denoise, render_aovs

        aovs_d = render_aovs(cfg, scene, pos, quat, min(args.spp, 16), key, bvh=bvh)
        img = denoise(torch.from_numpy(img).to(dev), aovs_d["albedo"], aovs_d["normal"],
                      aovs_d["depth"]).cpu().numpy()
    if args.bloom > 0.0:
        from raytracing_engine_tpu_torch.utils import bloom

        img = bloom(img, strength=args.bloom)
    if args.tonemap != "none" or args.exposure != 1.0 or args.gamma != 1.0:
        from raytracing_engine_tpu_torch.utils import tonemap

        img = tonemap(img, args.tonemap, args.exposure, args.gamma)
    write_png(out, img)
    print(f"{out}  {dt:.1f}s  ({float(nrays)/1e6:.1f} Mrays)"
          + ("  [denoised]" if args.denoise else ""))
    if args.aov:
        from raytracing_engine_tpu_torch.pathtracer import render_aovs

        aovs = {k: v.cpu().numpy() for k, v in render_aovs(
            cfg, scene, pos, quat, min(args.spp, 16), key, bvh=bvh,
            ao_radius=args.ao_radius).items()}
        stem = out[:-4] if out.endswith(".png") else out
        if "ao" in aovs:
            write_png(f"{stem}_ao.png", np.repeat(aovs["ao"][..., None], 3, -1))
        write_png(f"{stem}_albedo.png", aovs["albedo"])
        # normals in [-1,1] -> visualize in [0,1]
        write_png(f"{stem}_normal.png", aovs["normal"] * 0.5 + 0.5)
        dep = aovs["depth"]
        lo, hi = dep[dep > 0].min() if (dep > 0).any() else 0.0, dep.max()
        dvis = np.where(dep > 0, 1.0 - (dep - lo) / max(hi - lo, 1e-6), 0.0)
        write_png(f"{stem}_depth.png", np.repeat(dvis[..., None], 3, -1))
        print(f"{stem}_{{albedo,normal,depth}}.png  (denoiser guide planes)")


def cmd_instanced(args):
    """Shaded orbit frames of the instanced torus-knot grid (config 5)."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        torus_knot,
    )
    from raytracing_engine_tpu_torch.models.instanced import render_instanced_phong
    from raytracing_engine_tpu_torch.ops.cuda.instanced import pack_instances
    from raytracing_engine_tpu_torch.utils import write_png

    dev = resolve(args.device)
    w, h = _parse_size(args.size)
    nx, ny = _parse_size(args.grid)
    mesh = torus_knot(segments=args.segments, sides=32)
    bvh = build_bvh(mesh, device=dev)
    cs = build_clusters(mesh, device=dev)
    inst = grid_instances(bvh, nx=nx, ny=ny, spacing=4.0, base=(0.0, 14.0, 0.0),
                          mats=np.arange(nx * ny, dtype=np.int32) % 3, device=dev)
    tab = pack_instances(inst)
    mat_albedo = torch.tensor([[0.8, 0.5, 0.3], [0.4, 0.7, 0.5], [0.5, 0.5, 0.8]],
                              device=dev)
    light = torch.tensor([6.0, 2.0, 8.0], device=dev)
    print(f"{inst.total_triangles} triangles ({inst.num_instances} instances)")

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        yaw = np.float32(0.5 * i / max(args.frames - 1, 1))
        t0 = time.perf_counter()
        img = render_instanced_phong(
            tab, cs, inst.mat, mat_albedo, torch.zeros(3, device=dev), yaw, light,
            width=w, height=h, shadows=not args.no_shadows,
            light_radius=args.light_radius, shadow_samples=args.shadow_samples)
        _wait(img)
        ms = (time.perf_counter() - t0) * 1e3
        write_png(os.path.join(args.out, f"frame_{i:04d}.png"), img.cpu().numpy())
        print(f"frame {i:3d}: {ms:8.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raytracing_engine_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_option(p):
        p.add_argument("--device", default="cuda",
                       help="torch device of the run (default cuda: the card, which must "
                            "exist; cpu runs the kernels' plain versions)")

    r = sub.add_parser("render", help="single cone-march frame of the default scene")
    r.add_argument("--size", default="512x512")
    r.add_argument("--out", default="out")
    r.add_argument("--engine", choices=["pallas", "jnp"], default="pallas",
                   help="pallas = the hand-written kernels (K1, K2), jnp = the plain renderer")
    device_option(r)
    r.set_defaults(fn=cmd_render)

    o = sub.add_parser("orbit", help="camera-orbit sequence (interactive analog)")
    o.add_argument("--size", default="512x512")
    o.add_argument("--frames", type=int, default=60)
    o.add_argument("--out", default="orbit")
    o.add_argument("--apng", default=None,
                   help="write a lossless animated PNG instead of frames/")
    o.add_argument("--resume", action="store_true",
                   help="skip frames already in --out (PNG sink only; "
                        "poses are deterministic, so resumed frames are "
                        "bit-identical to an uninterrupted run)")
    o.add_argument("--y4m", default=None,
                   help="write a YUV4MPEG2 video instead of PNG frames")
    o.add_argument("--fps", type=int, default=30)
    o.add_argument("--chunk", type=int, default=8,
                   help="frames per sequence, copied to the host together "
                        "(1 = one frame at a time)")
    device_option(o)
    o.set_defaults(fn=cmd_orbit)

    rp = sub.add_parser(
        "replay",
        help="play a recorded input stream (runtime/replay.py) deterministically")
    rp.add_argument("replay", help="replay file (JSONL, see runtime/replay.py)")
    rp.add_argument("--size", default="512x512")
    rp.add_argument("--out", default="replay_out")
    rp.add_argument("--y4m", default=None)
    rp.add_argument("--apng", default=None,
                    help="write a lossless animated PNG instead of frames/")
    rp.add_argument("--fps", type=int, default=30)
    rp.add_argument("--monitor", default="1920x1080",
                    help="borderless-fullscreen resolution an F11 event "
                         "switches to (the reference reads the real "
                         "monitor's mode, src/main.rs:689-696)")
    rp.add_argument("--chunk", type=int, default=8,
                    help="frames per sequence (replay events are known "
                         "ahead; 1 = one frame at a time)")
    device_option(rp)
    rp.set_defaults(fn=cmd_replay)

    p = sub.add_parser("pt", help="path-trace a scene")
    p.add_argument("--scene", default="cornell",
                   help="cornell | glass (cornell w/ a dielectric ball) | "
                        "spheres | knot | obj | FILE.json "
                        "(declarative scene, pathtracer/sceneio.py schema)")
    p.add_argument("--mesh", default=None,
                   help="OBJ file for --scene obj (lit by the knot-scene lights)")
    p.add_argument("--size", default="256x256")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius, world units (0 = pinhole)")
    p.add_argument("--focus", type=float, default=10.0,
                   help="focus distance along the view axis (with --aperture)")
    p.add_argument("--sampler", default="random", choices=["random", "r2"],
                   help="r2 = low-discrepancy camera/NEE sampling")
    p.add_argument("--rr", type=int, default=0, metavar="BOUNCE",
                   help="Russian-roulette path termination from this bounce "
                        "on (0 = off); unbiased, prunes dim deep paths")
    p.add_argument("--orbit", type=int, default=0, metavar="FRAMES",
                   help="render a path-traced camera orbit instead of one "
                        "frame (sink: --apng or --out dir)")
    p.add_argument("--orbit-radius", type=float, default=10.0)
    p.add_argument("--orbit-height", type=float, default=2.0)
    p.add_argument("--orbit-target", type=float, nargs=3, default=(0.0, 6.0, 0.0))
    p.add_argument("--temporal", action="store_true",
                   help="temporal reprojection accumulation across orbit "
                        "frames (low-spp frames inherit history)")
    p.add_argument("--apng", default=None, metavar="FILE")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="per-tile adaptive sampling tolerance (--mega "
                        "only)")
    p.add_argument("--aov", action="store_true",
                   help="also write first-hit albedo/normal/depth PNGs "
                        "(denoiser guide planes)")
    p.add_argument("--ao-radius", type=float, default=0.0,
                   help="with --aov: also write a ray-traced ambient-"
                        "occlusion plane probed within this radius")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided a-trous denoise of the beauty pass "
                        "(the low-spp real-time pattern)")
    p.add_argument("--fog", type=float, default=0.0, metavar="DENSITY",
                   help="homogeneous Beer-Lambert fog density (0 = off; not ported yet)")
    p.add_argument("--fog-color", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--bloom", type=float, default=0.0, metavar="STRENGTH",
                   help="HDR bloom before tonemapping (0 = off)")
    p.add_argument("--tonemap", default="none", choices=["none", "reinhard", "aces"],
                   help="HDR->display curve for the beauty PNG")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear radiance scale before tonemapping")
    p.add_argument("--gamma", type=float, default=1.0,
                   help="final 1/gamma encode (2.2 for sRGB-ish output; "
                        "default 1.0 = the reference's linear UNORM present)")
    p.add_argument("--tex-filter", choices=["nearest", "bilinear", "trilinear"],
                   default="nearest", dest="tex_filter",
                   help="atlas texture filtering (trilinear = ray-cone mip LOD)")
    p.add_argument("--rng", choices=["threefry", "pcg", "pallas"], default="pcg")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bvh", action="store_true")
    p.add_argument("--smooth", action="store_true",
                   help="interpolated vertex-normal shading for --scene "
                        "obj/knot (OBJ vn records when present, else "
                        "computed welded-vertex normals; needs --bvh)")
    p.add_argument("--segments", type=int, default=1100)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--engine", default="auto", choices=["auto", "fast", "mega", "rebin"],
                   help="execution path: fast = the wavefront path tracer, mega = "
                        "the megakernel K4 (whole bounce loop in one launch), "
                        "rebin = K5, one launch a bounce with a ray regroup "
                        "between bounces (needs --bvh). auto picks rebin for "
                        "cluster meshes, mega with --adaptive, fast otherwise")
    p.add_argument("--mega", action="store_true", help="legacy alias for --engine mega")
    p.add_argument("--out", default=None)
    device_option(p)
    p.set_defaults(fn=cmd_pt)

    i = sub.add_parser(
        "instanced",
        help="shaded orbit of the 1M-triangle instanced scene (config 5)")
    i.add_argument("--size", default="960x544")
    i.add_argument("--frames", type=int, default=8)
    i.add_argument("--segments", type=int, default=550)
    i.add_argument("--grid", default="6x5")
    i.add_argument("--no-shadows", action="store_true")
    i.add_argument("--light-radius", type=float, default=0.0,
                   help="area-light radius for soft shadows (0 = hard)")
    i.add_argument("--shadow-samples", type=int, default=1,
                   help="shadow rays per pixel (area-light sampling)")
    i.add_argument("--out", default="instanced")
    device_option(i)
    i.set_defaults(fn=cmd_instanced)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
