"""The port's env map and rough glass (pathtracer/scene.py build_env_map,
pathtracer/wavefront.py _sample_env and the rough-dielectric branch)
against the JAX package on the CPU, inputs made from numpy seeds.

- _alias_table and build_env_map bit for bit with JAX's;
- _poly_atan2, _poly_acos, _env_texel_of, _env_pdf_w and _sample_env on
  4096 seeded inputs within rtol 1e-6 / atol 1e-7, with a correctly rounded
  square root (PyTorch's float32 sqrt on the CPU is not; XLA's is);
- one "env" scene (an equirect HDR map with a sun, rough and smooth glass,
  metal, a diffuse floor, a small sphere light) built in both packages: its
  arrays equal JAX's, and the plain render_pt_fast and render_pt_mega
  against JAX's render_pt_fast(rng="pcg") at 32x16, 3 bounces, 2 spp,
  within tests/test_megakernel.py:37-40's bounds;
- the plain rebin route (K5's) equals the plain megakernel bit for bit on
  a ClusterSet version of that scene;
- the static gates: glass at roughness 0 renders bit for bit like glass
  without the key, also with the rough-glass branch forced on; a scene
  without the new features calls the same PyTorch operations, in the same
  order, as before the features existed;
- a JSON scene with env {"image": path.npy} and a rough dielectric loads
  to JAX's arrays.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels' branches need the card:
chip_smoke.py phase 20 holds them to these plain versions.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.pathtracer import scene as jscene_mod
from raytracing_engine_tpu.pathtracer import wavefront as jwave
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json as jax_load
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import (
    DIELECTRIC,
    METAL,
    PTConfig,
    build_pt_scene,
    load_scene_json,
    pt_scene_from_numpy,
    scenes,
    wavefront,
)
from raytracing_engine_tpu_torch.pathtracer import scene as scene_mod
from raytracing_engine_tpu_torch.pathtracer.scene import OPTIONAL_FIELDS, TENSOR_FIELDS

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=3)
POS = (0.0, -1.5, 1.8)
QUAT = (-0.109778, 0.0, 0.0, 0.993956)  # examples/showcase.json's camera
FN_TOL = dict(rtol=1e-6, atol=1e-7)
FIELDS = TENSOR_FIELDS + OPTIONAL_FIELDS


def sky_image(h=16, w=32, seed=3):
    """An equirect HDR sky: a blue gradient, seeded noise and a sun texel of
    radiance 200 (row 3: 34 degrees above the horizon at h = 16)."""
    rng = np.random.default_rng(seed)
    th = (np.arange(h) + 0.5) / h
    img = (0.2 + 0.6 * (1.0 - th))[:, None, None] * np.array([0.5, 0.7, 1.0], np.float32)
    img = np.broadcast_to(img, (h, w, 3)) + rng.uniform(0.0, 0.05, (h, w, 3))
    img = img.astype(np.float32)
    img[3, 20] = 200.0
    return img


def env_scene_args(roughness=0.25, **kw):
    """The env scene's build_pt_scene arguments (both packages)."""
    rough = {"kind": DIELECTRIC, "ior": 1.5}
    if roughness is not None:
        rough["roughness"] = roughness
    mats = [{"albedo": (0.7, 0.7, 0.65)}, rough, {"kind": DIELECTRIC, "ior": 1.4},
            {"albedo": (0.9, 0.6, 0.3), "kind": METAL, "roughness": 0.2},
            {"albedo": (0.0, 0.0, 0.0), "emission": (20.0, 18.0, 15.0)}]
    spheres = [((0.0, 8.0, -1001.0), 1000.0, 0), ((-1.5, 6.0, 0.0), 1.0, 1),
               ((1.5, 7.0, 0.0), 1.0, 2), ((0.0, 9.0, 0.5), 1.0, 3), ((3.0, 4.0, 3.0), 0.5, 4)]
    return dict(spheres=spheres, materials=mats, env=sky_image(), env_rows=8, **kw)


def jax_arrays(js) -> dict:
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
            if getattr(js, f.name) is not None and not isinstance(getattr(js, f.name), (bool, int))}


def assert_same_scene(got, want: dict):
    for name in FIELDS:
        v = getattr(got, name)
        assert (v is None) == (name not in want), name
        if v is not None:
            np.testing.assert_array_equal(v.numpy(), want[name], err_msg=name)


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4, d.mean()
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


def cam():
    return torch.tensor(POS), torch.tensor(QUAT)


def correctly_rounded_sqrt(monkeypatch):
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


@pytest.fixture(scope="module")
def jax_side():
    """JAX's env scene and its render_pt_fast (pcg, PRNGKey(13)): one compile."""
    js = jax_build_pt_scene(**env_scene_args())
    img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), js, jnp.asarray(POS),
                                jnp.asarray(QUAT), 2, jax.random.PRNGKey(13))
    return dict(scene=js, arrays=jax_arrays(js), img=np.array(img), n=float(n))


def test_alias_table_and_env_map_match_jax():
    """Seeded pmfs (zeros and a spike among them) and HDR images, with and
    without a rows override, more rows than the budget and a black map."""
    rng = np.random.default_rng(11)
    for n in (1, 7, 128, 1024):
        p = rng.uniform(0.0, 1.0, n) * (rng.uniform(0.0, 1.0, n) > 0.3)
        p[rng.integers(n)] += 50.0
        p = p / p.sum()
        for got, want in zip(scene_mod._alias_table(p), jscene_mod._alias_table(p)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    images = [(sky_image(), None), (sky_image(40, 64, 5), None), (sky_image(9, 200, 6), 5),
              (np.zeros((4, 8, 3), np.float32), None)]
    for img, rows in images:
        got, want = scene_mod.build_env_map(img, rows), jscene_mod.build_env_map(img, rows)
        assert got[0].shape[0] == 3 * min(rows or img.shape[0], 32)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]


def test_env_functions_match_jax(monkeypatch):
    """The polynomial inverse trig and the env map's texel lookup, pdf and
    sampler on seeded directions and uniforms."""
    rng = np.random.default_rng(7)
    k = 4096
    dirs = rng.normal(size=(k, 3)).astype(np.float32)
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    y, x = (rng.normal(size=k).astype(np.float32) for _ in range(2))
    c = rng.uniform(-1.0, 1.0, k).astype(np.float32)
    s, j1, j2 = (rng.uniform(0.0, 1.0, k).astype(np.float32) for _ in range(3))
    js = jax_build_pt_scene(**env_scene_args())
    ps = build_pt_scene(device=CPU, **env_scene_args())
    K = ps.env_img.shape[0] // 3

    def run(mod, scene, cast):
        # (64, 64) planes: JAX's texel fetch gathers along the last axis
        cast = (lambda f: lambda a: f(np.ascontiguousarray(a.reshape(64, 64))))(cast)
        d = tuple(cast(dirs[:, a]) for a in range(3))
        ty, tx = mod._env_texel_of(d, K)
        sin_t = cast(np.abs(x) + 0.05)
        e_d, e_pdf, e_le = mod._sample_env(scene, cast(s), cast(j1), cast(j2))
        out = {"poly_atan2": mod._poly_atan2(cast(y), cast(x)),
               "poly_acos": mod._poly_acos(cast(c)),
               "sphere_uv": mod._sphere_uv(d), "env_texel_of": (ty, tx),
               "env_pdf_w": mod._env_pdf_w(scene, ty, tx, sin_t),
               "sample_env": (*e_d, e_pdf, *e_le)}
        return {key: np.stack([np.asarray(v, np.float32) for v in
                               (val if isinstance(val, tuple) else (val,))])
                for key, val in out.items()}

    want = run(jwave, js, jnp.asarray)
    correctly_rounded_sqrt(monkeypatch)
    got = run(wavefront, ps, torch.from_numpy)
    assert list(got) == list(want)
    for key in want:
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **FN_TOL)
    # the sampler's draws reach the sun texel and its pdfs are positive
    assert (want["sample_env"][4:] > 100.0).any() and (want["sample_env"][3] > 0).all()


def test_envmap_scene_matches_jax(jax_side):
    """The port's build equals JAX's array for array, and so does
    pt_scene_from_numpy of JAX's arrays; the static gates and the packed
    material table agree."""
    port = build_pt_scene(device=CPU, **env_scene_args())
    js = jax_side["scene"]
    assert_same_scene(port, jax_side["arrays"])
    assert_same_scene(pt_scene_from_numpy(jax_side["arrays"], device=CPU), jax_side["arrays"])
    for flag in ("has_env_map", "has_rough_dielectric", "has_metal", "has_dielectric"):
        assert getattr(port, flag) == getattr(js, flag) is True, flag
    assert not port.has_env and port.has_material_features and not port.needs_uv
    assert 0.0 < float(port.env_pick) < 1.0
    _, _, mat, _, _, _ = pt.pack_pt_scene(port)
    np.testing.assert_array_equal(mat[:, 8].numpy(), jax_side["arrays"]["mat_rough"])
    tabs = pt.feature_tables(port)
    assert tabs["env_img"].shape == (24, 128) and tabs["env_pick"].shape == (1,)
    assert tabs["atlas"] is None and tabs["tri_uvs"] is None
    # an explicit pick, and a map alone (no light slots: pick 1)
    lone = env_scene_args(env_pick=0.3)
    assert float(build_pt_scene(device=CPU, **lone).env_pick) == np.float32(0.3)
    lone["materials"][4]["emission"] = (0.0, 0.0, 0.0)
    assert float(build_pt_scene(device=CPU, **lone).env_pick) == 1.0


def test_renders_match_jax(jax_side):
    """The plain render_pt_fast and render_pt_mega against JAX's
    render_pt_fast at 32x16, 3 bounces, 2 spp."""
    scene = build_pt_scene(device=CPU, **env_scene_args())
    cfg = PTConfig(**SIZE, rng="pcg")
    want, n_want = jax_side["img"], jax_side["n"]
    fast, n_fast = wavefront.render_pt_fast(cfg, scene, *cam(), 2, seed=seed_from_int(13))
    mega, n_mega = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(13))
    assert torch.equal(fast, mega) and int(n_fast) == int(n_mega)
    assert fast.shape == (16, 32, 3) and torch.isfinite(fast).all()
    hold_megakernel_bounds(fast.numpy(), n_fast, want, n_want)
    assert 0.05 < want.mean() < 5.0


def materials():
    """tests/test_torch_materials.py's materials scene (metal, anisotropy,
    checker, dispersion, gradient sky)."""
    mats = [
        {"albedo": (0.8, 0.75, 0.7), "checker": {"color": (0.15, 0.2, 0.3), "scale": 1.0}},
        {"albedo": (0.95, 0.75, 0.35), "kind": METAL, "roughness": 0.2},
        {"albedo": (0.7, 0.8, 0.9), "kind": METAL, "roughness": 0.15, "roughness_y": 0.5},
        {"kind": DIELECTRIC, "ior": 1.5, "dispersion": 0.08},
        {"albedo": (0.0, 0.0, 0.0), "emission": (25.0, 24.0, 22.0)},
    ]
    spheres = [((0.0, 8.0, -1001.0), 1000.0, 0), ((-2.5, 7.0, 0.2), 1.0, 1),
               ((2.6, 7.0, -0.2), 0.9, 2), ((0.0, 6.0, 0.2), 1.2, 3), ((4.0, 3.0, 4.0), 0.8, 4)]
    return dict(spheres=spheres, materials=mats, env=((0.15, 0.15, 0.2), (0.5, 0.65, 0.95)))


def mesh_scene(**kw):
    """The env scene with a diffuse icosphere (a ClusterSet)."""
    tris = icosphere(subdivisions=1, radius=0.9, center=(2.6, 9.0, 1.5))
    args = env_scene_args(**kw)
    args["materials"] = args["materials"] + [{"albedo": (0.7, 0.3, 0.2)}]
    mats = np.full(len(tris), len(args["materials"]) - 1, np.int32)
    scene = build_pt_scene(device=CPU, triangles=tris, tri_mats=mats, **args)
    return scene, build_clusters(tris, tri_mats=mats, device=CPU)


def test_rebin_route_equals_megakernel():
    """K5's plain route (one staged bounce per call over the 17-plane state,
    regrouped between bounces) equals the plain megakernel bit for bit."""
    scene, cs = mesh_scene()
    cfg = PTConfig(width=24, height=12, max_bounces=3, rng="pcg")
    mega, n_mega = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(5), bvh=cs)
    for rebin in ("none,morton", "oct,tile_oct"):
        got, n = pt.render_pt_rebin(cfg, scene, *cam(), 2, seed=seed_from_int(5), bvh=cs,
                                    rebin=rebin)
        assert torch.equal(got, mega) and int(n) == int(n_mega), rebin
    assert wavefront.state_plane_count(scene) == 17 and mega.mean() > 0


class _Trace(TorchFunctionMode):
    """The names of the PyTorch functions called, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


# The operation traces of render_pt_fast (8x4, 2 bounces, 1 spp, pcg) on the
# materials scene of tests/test_torch_materials.py and on cornell_box, taken
# before the env map, UV textures and rough glass existed: (calls, the first
# 16 hex digits of sha256("\n".join(names))) with torch 2.13.0.
PARENT_TRACES = {"materials": (6254, "4b1fb39076c40e79"), "cornell": (8971, "08ab30e5d84c9f3c")}


def test_static_gates():
    """Glass at roughness 0 renders bit for bit like glass without the key,
    also with the rough-glass branch forced on (the column present and
    zero); scenes without the new features call the same operations as
    before them."""
    cfg = PTConfig(**SIZE, rng="pcg")
    zero = build_pt_scene(device=CPU, **env_scene_args(roughness=0.0))
    none = build_pt_scene(device=CPU, **env_scene_args(roughness=None))
    assert not zero.has_rough_dielectric and zero.mat_rough is not None  # the metal's
    forced = dataclasses.replace(zero, has_rough_dielectric=True)
    want, n_want = pt.render_pt_mega(cfg, none, *cam(), 2, seed=seed_from_int(9))
    for scene in (zero, forced):
        got, n = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(9))
        assert torch.equal(got, want) and int(n) == int(n_want)
    rough = build_pt_scene(device=CPU, **env_scene_args())
    assert not torch.equal(pt.render_pt_mega(cfg, rough, *cam(), 2, seed=seed_from_int(9))[0],
                           want)

    small = PTConfig(width=8, height=4, max_bounces=2, rng="pcg")
    for name, scene in (("materials", build_pt_scene(device=CPU, **materials())),
                        ("cornell", scenes.cornell_box(device=CPU))):
        pos, quat = cam()
        with _Trace() as t:
            wavefront.render_pt_fast(small, scene, pos, quat, 1, seed=seed_from_int(3))
        digest = hashlib.sha256("\n".join(t.names).encode()).hexdigest()[:16]
        assert (len(t.names), digest) == PARENT_TRACES[name], name


def test_json_env_map_and_rough_glass_load_to_jax_arrays(tmp_path):
    """env {"image": path.npy, "rows", "pick"} and a rough dielectric: the
    port's load_scene_json gives JAX's arrays."""
    np.save(str(tmp_path / "sky.npy"), sky_image(12, 24, 8))
    spec = {"materials": [{"albedo": [0.7, 0.7, 0.7]},
                          {"kind": "dielectric", "ior": 1.5, "roughness": 0.3},
                          {"albedo": [0, 0, 0], "emission": [9, 9, 9]}],
            "spheres": [{"center": [0, 6, 0], "radius": 1, "mat": 1},
                        {"center": [0, 6, -101], "radius": 100, "mat": 0},
                        {"center": [2, 3, 3], "radius": 0.4, "mat": 2}],
            "env": {"image": "sky.npy", "rows": 6, "pick": 0.4}}
    path = str(tmp_path / "env.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    got, want = load_scene_json(path, device="cpu").scene, jax_load(path).scene
    assert_same_scene(got, jax_arrays(want))
    assert got.has_rough_dielectric == want.has_rough_dielectric is True
    assert got.env_img.shape == (18, 128) and float(got.env_pick) == np.float32(0.4)
