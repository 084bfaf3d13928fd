"""The port's command line (cli.py) against the JAX package's and against
the port's own entry points, on the CPU (``--device cpu``).

- Every subcommand parses to the JAX package's options, defaults and one
  full argv each; the only extra key is the port's ``device``.
- ``render --engine jnp``: the PNG within 1 LSB of the JAX CLI's (the
  renderers' image tolerance, rtol 1e-3 / atol 2e-3, is under 0.77 LSB on
  values in [0, 1]); ``--engine pallas`` bit for bit the kernels' wrapper
  (models/cuda_renderer.render) on CPU tensors; without CUDA, the default
  device raises before anything is written.
- ``orbit``: ``--resume`` bit for bit an uninterrupted run and the
  renderer at the orbit's poses; ``--apng`` holds the same frames.
- ``replay``: the PNGs of a recorded stream (focus loss, fullscreen
  toggle) bit for bit FrameLoop.run's frames, chunked and frame by frame.
- ``pt --checkpoint`` to 4 and then 8 spp: the accumulated sums within the
  megakernel bounds of the JAX CLI's (tests/test_megakernel.py:37-40, as
  tests/test_torch_pt_render.py holds render_pt_fast); each CLI resumes
  the other's 4-spp checkpoint.
- The ``pt`` routes: ``--scene obj --bvh`` renders a skip-link BVH through
  render_pt_fast and ``--engine rebin`` a ClusterSet through
  render_pt_rebin, each bit for bit the direct call; rebin without
  ``--bvh`` exits naming rebin; ``--aperture``, ``--sampler r2`` and
  ``--mega --adaptive`` write their direct calls' PNGs bit for bit, and so
  do ``--fog`` (the wavefront and ``--mega``) and a scene file with
  ``mesh_lights`` (``--bvh``: a raw BVH on the CPU).
- ``instanced`` bit for bit render_instanced_phong.

Calling the JAX CLI costs an interpret-mode compile on its orbit, rebin and
instanced routes (tests/test_cli.py), so those hold the port's CLI to the
port's direct calls, which other files hold to JAX. chip_smoke.py phase 21
runs the subcommands on the card.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from raytracing_engine_tpu import cli as jax_cli

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch import cli
from raytracing_engine_tpu_torch.accel import (
    BVH,
    ClusterSet,
    build_bvh,
    build_clusters,
    grid_instances,
    icosphere,
    load_obj,
    make_instanced_clusters,
    make_instances,
    save_obj,
    torus_knot,
)
from raytracing_engine_tpu_torch.camera import Camera, orbit_path
from raytracing_engine_tpu_torch.models import cuda_renderer
from raytracing_engine_tpu_torch.models.instanced import render_instanced_phong
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.cuda.instanced import pack_instances
from raytracing_engine_tpu_torch.ops.rng_pcg import prng_key_data
from raytracing_engine_tpu_torch.pathtracer import (
    DIFFUSE,
    PTConfig,
    build_pt_scene,
    load_scene_json,
    scenes,
)
from raytracing_engine_tpu_torch.pathtracer import wavefront
from raytracing_engine_tpu_torch.runtime import (
    FrameLoop,
    InputEvent,
    load_checkpoint,
    save_replay,
)
from raytracing_engine_tpu_torch.utils.image import read_png, to_srgb_u8
from raytracing_engine_tpu_torch.utils.video import read_apng

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
CMDS = ("cmd_render", "cmd_orbit", "cmd_replay", "cmd_pt", "cmd_instanced")
U8_LSB = 1
KEY0 = prng_key_data(0)  # jax.random.PRNGKey(0), the CLI's default --seed

FULL_ARGV = {
    "render": ["render", "--size", "32x16", "--out", "o", "--engine", "jnp"],
    "orbit": ["orbit", "--size", "40x24", "--frames", "5", "--out", "o", "--apng", "a.png",
              "--resume", "--y4m", "v.y4m", "--fps", "12", "--chunk", "3"],
    "replay": ["replay", "s.replay", "--size", "40x24", "--out", "o", "--y4m", "v.y4m",
               "--apng", "a.png", "--fps", "12", "--monitor", "64x48", "--chunk", "2"],
    "pt": ["pt", "--scene", "knot", "--mesh", "m.obj", "--size", "40x24", "--spp", "3",
           "--bounces", "2", "--aperture", "0.1", "--focus", "5", "--sampler", "r2", "--rr",
           "1", "--orbit", "4", "--orbit-radius", "3", "--orbit-height", "1",
           "--orbit-target", "1", "2", "3", "--temporal", "--apng", "a.png", "--fps", "12",
           "--adaptive", "0.1", "--aov", "--ao-radius", "0.5", "--denoise", "--fog", "0.2",
           "--fog-color", "0.1", "0.2", "0.3", "--bloom", "0.5", "--tonemap", "aces",
           "--exposure", "2", "--gamma", "2.2", "--tex-filter", "bilinear", "--rng", "pallas",
           "--seed", "7", "--bvh", "--smooth", "--segments", "50", "--checkpoint", "c.npz",
           "--fresh", "--engine", "rebin", "--mega", "--out", "x.png"],
    "instanced": ["instanced", "--size", "40x24", "--frames", "3", "--segments", "60",
                  "--grid", "2x3", "--no-shadows", "--light-radius", "0.5",
                  "--shadow-samples", "4", "--out", "o"],
}


def parsed(module, argv, monkeypatch) -> dict:
    """The Namespace module.main(argv) hands its subcommand, as a dict."""
    got = []
    for name in CMDS:
        monkeypatch.setattr(module, name, got.append)
    module.main(argv)
    ns = vars(got.pop())
    del ns["fn"]
    return ns


def run(argv):
    cli.main(argv + CPU)


def png(path):
    return read_png(str(path))


def test_options_match_jax(monkeypatch):
    for name, full in FULL_ARGV.items():
        short = [name] + (["s.replay"] if name == "replay" else [])
        for argv in (short, full):
            want = parsed(jax_cli, argv, monkeypatch)
            got = parsed(cli, argv, monkeypatch)
            assert got.pop("device") == "cuda"
            assert got == want, argv
        assert parsed(cli, full + ["--device", "cpu"], monkeypatch)["device"] == "cpu"
    with pytest.raises(SystemExit):  # the choices are JAX's
        cli.main(["pt", "--engine", "pallas"])


def test_render_matches_jax_and_the_kernels(tmp_path):
    jax_cli.main(["render", "--size", "64x64", "--out", str(tmp_path / "jax"),
                  "--engine", "jnp"])
    run(["render", "--size", "64x64", "--out", str(tmp_path / "jnp"), "--engine", "jnp"])
    got, want = png(tmp_path / "jnp" / "frame_0000.png"), png(tmp_path / "jax" / "frame_0000.png")
    assert got.shape == (64, 64, 3) and got.max() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= U8_LSB

    run(["render", "--size", "64x64", "--out", str(tmp_path / "pallas")])
    cam = Camera.initial()
    img = cuda_renderer.render(rtt.RenderConfig(64, 64), rtt.default_scene("cpu"),
                               cam.position, cam.quat())
    np.testing.assert_array_equal(png(tmp_path / "pallas" / "frame_0000.png"),
                                  to_srgb_u8(img.numpy()))
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["render", "--size", "64x64", "--out", str(tmp_path / "none")])
        assert not (tmp_path / "none").exists()


def test_orbit_resume_and_apng_are_bit_for_bit(tmp_path):
    full, part, apng = tmp_path / "full", tmp_path / "part", str(tmp_path / "o.apng")
    argv = ["orbit", "--size", "48x32", "--frames", "3", "--chunk", "2"]
    run(argv + ["--out", str(full)])
    run(argv + ["--out", str(part)])
    os.remove(part / "frame_0001.png")
    before = png(part / "frame_0000.png")
    run(argv + ["--out", str(part), "--resume"])
    run(argv + ["--apng", apng, "--chunk", "1"])
    frames, fps = read_apng(apng)
    assert fps == 30 and frames.shape == (3, 32, 48, 3)
    positions, rotations = orbit_path(3)
    cfg, scene = rtt.RenderConfig(48, 32), rtt.default_scene("cpu")
    for i in range(3):
        want = png(full / f"frame_{i:04d}.png")
        cam = Camera(positions[i], rotations[i])
        direct = cuda_renderer.render(cfg, scene, cam.position, cam.quat())
        np.testing.assert_array_equal(want, to_srgb_u8(direct.numpy()))
        np.testing.assert_array_equal(png(part / f"frame_{i:04d}.png"), want)
        np.testing.assert_array_equal(frames[i], want)
    np.testing.assert_array_equal(png(part / "frame_0000.png"), before)


def test_replay_equals_frame_loop(tmp_path):
    events = [InputEvent(move=(0.0, 1.0, 0.0), dt=0.05),
              InputEvent(rot=(1.0, 0.0), cursor=(6.0, -2.0), dt=0.05),
              InputEvent(focus=False), InputEvent(move=(1.0, 0.0, 0.0)),
              InputEvent(focus=True, move=(0.0, 0.0, 1.0), dt=0.02),
              InputEvent(fullscreen_toggle=True), InputEvent(move=(-1.0, 0.0, 0.0), dt=0.03),
              InputEvent(fullscreen_toggle=True), InputEvent(quit=True),
              InputEvent(move=(0.0, 1.0, 0.0))]
    path = str(tmp_path / "s.replay")
    save_replay(path, events)
    want = {}
    loop = FrameLoop(rtt.RenderConfig(48, 32), rtt.default_scene("cpu"), monitor=(64, 48))
    loop.run(events, sink=want.__setitem__)
    assert sorted(want) == [0, 1, 2, 3, 4, 5, 6, 7]  # frozen 2-3 present the last frame
    for chunk in ("1", "8"):
        out = tmp_path / f"chunk{chunk}"
        run(["replay", path, "--size", "48x32", "--monitor", "64x48", "--chunk", chunk,
             "--out", str(out)])
        names = sorted(os.listdir(out))
        idx = [0, 1, 2, 3, 4, 5, 6, 7] if chunk == "1" else [0, 1, 4, 5, 6, 7]
        assert names == [f"frame_{i:04d}.png" for i in idx]
        for i in idx:
            np.testing.assert_array_equal(png(out / f"frame_{i:04d}.png"), to_srgb_u8(want[i]))
    assert png(out / "frame_0005.png").shape == (48, 64, 3)


def test_pt_checkpoint_matches_jax_and_resumes_across(tmp_path):
    argv = ["pt", "--scene", "cornell", "--size", "32x32", "--bounces", "2"]
    cks = {name: str(tmp_path / f"{name}.npz") for name in ("port", "jax", "p2j", "j2p")}

    def both(spp, port_ck, jax_ck):
        run(argv + ["--spp", spp, "--checkpoint", port_ck, "--out", str(tmp_path / "p.png")])
        jax_cli.main(argv + ["--spp", spp, "--checkpoint", jax_ck,
                             "--out", str(tmp_path / "j.png")])

    both("4", cks["port"], cks["jax"])
    shutil.copy(cks["port"], cks["p2j"])  # the port's 4 spp, resumed by JAX's CLI
    shutil.copy(cks["jax"], cks["j2p"])   # and JAX's, resumed by the port's
    port4, jax4 = (np.load(cks[k])["accum"] for k in ("port", "jax"))
    both("8", cks["port"], cks["jax"])
    both("8", cks["j2p"], cks["p2j"])
    z = {k: np.load(v) for k, v in cks.items()}
    for k, v in z.items():
        assert int(v["spp_done"]) == 8, k
        np.testing.assert_array_equal(v["key"], KEY0)
        np.testing.assert_array_equal(v["cam_pos"], np.float32([0.0, 0.2, 0.0]))

    # the port's 8 spp against JAX's: the megakernel bounds
    d = np.abs(z["port"]["accum"] / 8 - z["jax"]["accum"] / 8).max(-1)
    assert (d > 1e-3).mean() < 0.01 and d.mean() < 1e-4, d.max()
    # JAX's 4 spp resumed by the port: its own passes 4-7 added to JAX's sum,
    # bit for bit
    cfg = PTConfig(width=32, height=32, max_bounces=2, rng="pcg")
    state = load_checkpoint(cks["j2p"], device="cpu")
    tail, _ = wavefront.render_pt_fast(cfg, scenes.cornell_box(device="cpu"), state.cam_pos,
                                       state.cam_quat, 4, KEY0, spp_offset=4)
    np.testing.assert_array_equal(z["j2p"]["accum"], (torch.from_numpy(jax4) + tail * 4.0).numpy())
    # the port's 4 spp resumed by JAX: JAX's passes 4-7 (float rounding of the sums)
    np.testing.assert_allclose(z["p2j"]["accum"] - port4, z["jax"]["accum"] - jax4,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(load_checkpoint(cks["port"], device="cpu").key, KEY0)


def knot_scene(mesh):
    """cli.cmd_pt's scene for --scene knot / obj."""
    mats = [{"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (10.0, 10.0, 10.0), "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}]
    return build_pt_scene(spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
                          triangles=mesh, tri_mats=np.zeros(len(mesh), np.int32),
                          materials=mats, device="cpu")


def test_pt_routes_and_refusals(tmp_path, monkeypatch):
    obj = str(tmp_path / "ball.obj")
    save_obj(obj, icosphere(subdivisions=1, radius=1.5, center=(0.0, 6.0, 0.0)))
    mesh = load_obj(obj)
    scene = knot_scene(mesh)
    pos, quat = torch.zeros(3), torch.tensor([0.0, 0.0, 0.0, 1.0])
    cfg = PTConfig(width=32, height=16, max_bounces=2, rng="pcg")
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def call(*args, **kw):
            seen.append((name, type(kw.get("bvh")).__name__))
            return real(*args, **kw)
        monkeypatch.setattr(module, name, call)

    import raytracing_engine_tpu_torch.pathtracer as pathtracer

    spy(pathtracer, "render_pt_fast")
    spy(pt, "render_pt_rebin")
    base = ["pt", "--scene", "obj", "--mesh", obj, "--size", "32x16", "--bounces", "2", "--bvh"]
    run(base + ["--spp", "2", "--out", str(tmp_path / "fast.png")])
    assert seen == [("render_pt_fast", BVH.__name__)]
    img, _ = wavefront.render_pt_fast(cfg, scene, pos, quat, 2, KEY0,
                                      bvh=build_bvh(mesh, device="cpu"))
    np.testing.assert_array_equal(png(tmp_path / "fast.png"), to_srgb_u8(img.numpy()))
    run(base + ["--spp", "1", "--engine", "rebin", "--out", str(tmp_path / "rebin.png")])
    assert seen[1:] == [("render_pt_rebin", ClusterSet.__name__)]
    cs = build_clusters(mesh, tri_mats=np.zeros(len(mesh), np.int32), device="cpu")
    img, _ = pt.render_pt_rebin(cfg, scene, pos, quat, 1, KEY0, bvh=cs)
    np.testing.assert_array_equal(png(tmp_path / "rebin.png"), to_srgb_u8(img.numpy()))

    with pytest.raises(SystemExit, match="rebin"):
        run(["pt", "--scene", "cornell", "--size", "32x32", "--spp", "1", "--bounces", "2",
             "--engine", "rebin"])
    # an instanced mesh with UVs under an image with its mip chain and a normal
    # map, filtered trilinearly (item 4 features 5-7) renders: auto takes K5's
    # route (its plain version here), bit for bit the direct call
    rng = np.random.default_rng(0)
    save_obj(obj, mesh, uvs=rng.random((len(mesh), 3, 2), np.float32))
    np.save(str(tmp_path / "tex.npy"), rng.uniform(0.2, 0.9, (4, 8, 3)).astype(np.float32))
    nrm = np.float32([0.3, -0.2, 1.0]) / np.linalg.norm([0.3, -0.2, 1.0])
    np.save(str(tmp_path / "nrm.npy"), np.broadcast_to((nrm + 1.0) * 0.5, (2, 2, 3)).copy())
    spec = {"materials": [{"albedo": [0.6, 0.6, 0.6], "image": {"npy": "tex.npy"},
                           "normal": {"npy": "nrm.npy"}},
                          {"albedo": [0, 0, 0], "emission": [5, 5, 5]}],
            "spheres": [{"center": [0, 8, 6], "radius": 1.0, "mat": 1}],
            "instances": {"mesh": {"obj": obj, "uvs": True}, "mat": 0,
                          "transforms": [{"translate": [0.0, 0.0, 0.0]}]},
            "tex_mips": True}
    (tmp_path / "inst.json").write_text(json.dumps(spec))
    run(["pt", "--scene", str(tmp_path / "inst.json"), "--size", "16x16", "--spp", "1",
         "--bounces", "1", "--tex-filter", "trilinear", "--out", str(tmp_path / "inst.png")])
    b = load_scene_json(str(tmp_path / "inst.json"), device="cpu")
    ins = b.instanced
    bvh_i = build_bvh(ins["mesh"], device="cpu")
    cs_i = build_clusters(ins["mesh"], bvh=bvh_i, tri_mats=np.zeros(len(ins["mesh"]), np.int32),
                          vertex_uvs=ins["uvs"], device="cpu")
    ic = make_instanced_clusters(make_instances(bvh_i, ins["transforms"], mats=np.zeros(1, np.int32),
                                                device="cpu"), cs_i, scene=b.scene, device="cpu")
    assert b.scene.has_mips and b.scene.has_normal_map and cs_i.has_uv
    img, _ = pt.render_pt_rebin(PTConfig(width=16, height=16, max_bounces=1, rng="pcg",
                                         tex_filter="trilinear"), b.scene,
                                torch.from_numpy(b.cam_pos), torch.from_numpy(b.cam_quat), 1,
                                KEY0, bvh=ic)
    np.testing.assert_array_equal(png(tmp_path / "inst.png"), to_srgb_u8(img.numpy()))
    # the features once refused render, each bit for bit its direct call: fog
    # (item 4 feature 9) through render_pt_fast and the megakernel, a scene
    # file's mesh lights (feature 13) through render_pt_fast over a raw BVH
    # (the CPU's --bvh)
    lit = {"materials": [{"albedo": [0.6, 0.6, 0.6]}, {"albedo": [0, 0, 0],
                                                       "emission": [5, 5, 5]}],
           "spheres": [{"center": [0, 6, -51.5], "radius": 50, "mat": 0}],
           "meshes": [{"obj": obj, "mat": 1}], "mesh_lights": True,
           "camera": {"position": [0.0, 0.0, 1.0], "quat": [0, 0, 0, 1]}}
    (tmp_path / "lit.json").write_text(json.dumps(lit))
    box, box_pos = scenes.cornell_box(device="cpu"), torch.tensor([0.0, 0.2, 0.0])
    fog = dict(width=16, height=16, max_bounces=1, rng="pcg", fog_density=0.1,
               fog_color=(0.2, 0.3, 0.4))
    b = load_scene_json(str(tmp_path / "lit.json"), device="cpu")
    assert b.scene.has_mesh_light
    refused = {
        "fog": (["--fog", "0.1", "--fog-color", "0.2", "0.3", "0.4"],
                lambda: wavefront.render_pt_fast(PTConfig(**fog), box, box_pos, quat, 1, KEY0)),
        "fog mega": (["--fog", "0.1", "--fog-color", "0.2", "0.3", "0.4", "--mega"],
                     lambda: pt.render_pt_mega(PTConfig(**fog), box, box_pos, quat, 1, KEY0)),
        "feature 13": (["--scene", str(tmp_path / "lit.json"), "--bvh"],
                       lambda: wavefront.render_pt_fast(
                           PTConfig(width=16, height=16, max_bounces=1, rng="pcg"), b.scene,
                           torch.from_numpy(b.cam_pos), torch.from_numpy(b.cam_quat), 1, KEY0,
                           bvh=build_bvh(b.tris, device="cpu"))),
    }
    for what, (extra, direct) in refused.items():
        out = tmp_path / "refused.png"
        run(["pt", "--size", "16x16", "--spp", "1", "--bounces", "1", "--out", str(out)]
            + extra)
        want = direct()[0]
        assert want.mean() > 0, what
        np.testing.assert_array_equal(png(out), to_srgb_u8(want.numpy()), err_msg=what)
    # the sampling features (item 4 features 10, 11 and 14) render, each bit for
    # bit its direct call: the thin lens and the R_d sampler through
    # render_pt_fast, adaptive spp through the megakernel
    box, box_pos = scenes.cornell_box(device="cpu"), torch.tensor([0.0, 0.2, 0.0])
    small = dict(width=16, height=16, max_bounces=1, rng="pcg")
    sampling = {
        "dof": (["--aperture", "0.1", "--focus", "5"],
                lambda: wavefront.render_pt_fast(PTConfig(**small, aperture=0.1, focus_dist=5.0),
                                                 box, box_pos, quat, 2, KEY0)),
        "r2": (["--sampler", "r2"],
               lambda: wavefront.render_pt_fast(PTConfig(**small, sampler="r2"), box, box_pos,
                                                quat, 2, KEY0)),
        "adaptive": (["--mega", "--adaptive", "0.05"],
                     lambda: pt.render_pt_mega(PTConfig(**small), box, box_pos, quat, 2, KEY0,
                                               adaptive_tol=0.05)),
    }
    for name, (extra, direct) in sampling.items():
        out = tmp_path / f"{name}.png"
        run(["pt", "--size", "16x16", "--spp", "2", "--bounces", "1", "--out", str(out)] + extra)
        np.testing.assert_array_equal(png(out), to_srgb_u8(direct()[0].numpy()), err_msg=name)


def test_instanced_equals_render_instanced_phong(tmp_path):
    run(["instanced", "--size", "32x24", "--frames", "2", "--segments", "40", "--grid", "2x1",
         "--out", str(tmp_path)])
    mesh = torus_knot(segments=40, sides=32)
    cs = build_clusters(mesh, device="cpu")
    inst = grid_instances(build_bvh(mesh, device="cpu"), nx=2, ny=1, spacing=4.0,
                          base=(0.0, 14.0, 0.0), mats=np.arange(2, dtype=np.int32) % 3,
                          device="cpu")
    alb = torch.tensor([[0.8, 0.5, 0.3], [0.4, 0.7, 0.5], [0.5, 0.5, 0.8]])
    for i, yaw in enumerate((0.0, 0.5)):
        img = render_instanced_phong(pack_instances(inst), cs, inst.mat, alb, torch.zeros(3),
                                     np.float32(yaw), torch.tensor([6.0, 2.0, 8.0]),
                                     width=32, height=24)
        assert img.max() > 0
        np.testing.assert_array_equal(png(tmp_path / f"frame_{i:04d}.png"),
                                      to_srgb_u8(img.numpy()))
