"""The port's path-tracer modules against the JAX package, stage by stage, on
the CPU.

- ops/rng_pcg: the PCG4D planes equal the JAX ones bit for bit on random
  coordinates, seeds and counters; the seed helpers equal key_to_seed;
- pathtracer/scene: pt_scene_from_numpy of the JAX scenes' arrays equals the
  port's own build_pt_scene, field for field, for the three scenes;
- pathtracer/wavefront stages (camera rays, sphere and triangle hits, the
  NEE light sample, occlusion): the same numpy planes through the JAX
  function and the port's, within atol 1e-6 / rtol 1e-5, indices and masks
  exactly;
- the device rule: every constructor called without a device raises when
  there is no CUDA; the inputs that once stood for features still to port
  (the env map, UV-space checkers, rough dielectrics, ... with mesh lights
  or the light tree) build the JAX package's scene field for field, and
  the configurations that did (fog, the tree, trilinear with the tree)
  render as JAX's render_pt_fast does.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.ops import rng_pcg as jrng
from raytracing_engine_tpu.ops.pallas.rng import key_to_seed
from raytracing_engine_tpu.pathtracer import scenes as jscenes
from raytracing_engine_tpu.pathtracer import wavefront as jwf
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch.ops import rng_pcg
from raytracing_engine_tpu_torch.ops.cuda import common, pt
from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes, wavefront
from raytracing_engine_tpu_torch.pathtracer.scene import (
    DIELECTRIC,
    METAL,
    TENSOR_FIELDS,
    build_pt_scene,
    pt_scene_from_numpy,
)
from raytracing_engine_tpu_torch.runtime import ProgressiveState, load_checkpoint
from raytracing_engine_tpu_torch.scene import make_scene, scene_from_numpy

torch.set_num_threads(1)

STAGE_TOL = dict(atol=1e-6, rtol=1e-5)
SCENES = ("material_spheres", "cornell_box", "furnace_scene")
N = (24, 20)  # stage-test plane shape


def jax_scene_arrays(jscene):
    """The JAX PTScene's non-None array fields as numpy arrays."""
    out = {}
    for f in dataclasses.fields(jscene):
        v = getattr(jscene, f.name)
        if v is not None and not isinstance(v, (bool, int)):
            out[f.name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX scene, port scene from its arrays) per scene name."""
    out = {}
    for name in SCENES:
        js = getattr(jscenes, name)()
        out[name] = (js, pt_scene_from_numpy(jax_scene_arrays(js), device="cpu"))
    return out


# --- RNG -------------------------------------------------------------------

@pytest.mark.parametrize("s", [0, 1, 13, 12345, 2**31 + 5, 2**32 - 1])
def test_seed_from_int_matches_key_to_seed(s):
    assert rng_pcg.seed_from_int(s) == int(key_to_seed(jax.random.PRNGKey(s)))
    data = np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
    assert rng_pcg.seed_from_key_data(data) == int(key_to_seed(jax.random.PRNGKey(s)))


def test_seed_examples_and_pass_seed():
    assert rng_pcg.seed_from_int(1) == -1640531535
    assert rng_pcg.seed_from_int(13) == 147926525
    base = rng_pcg.seed_from_int(1)
    for g in (0, 1, 7, 1023, 5000):
        want = jnp.int32(base) + jnp.int32(g) * jnp.int32(-1640531527)
        assert rng_pcg.pass_seed(base, g) == int(want)


@pytest.mark.parametrize("seed,ctr,n", [(-1640531535, 0, 2), (147926525, 3, 5),
                                        (0, 1, 6), (-7, 11, 9), (2**31 - 1, 0, 4)])
def test_uniform_pcg_coords_bit_exact(seed, ctr, n):
    rs = np.random.default_rng(abs(seed) % 1000 + ctr)
    px = rs.integers(0, 1 << 16, N).astype(np.int32)
    py = rs.integers(0, 1 << 16, N).astype(np.int32)
    want = jrng.uniform_pcg_coords(jnp.int32(seed), ctr, n, jnp.asarray(px), jnp.asarray(py))
    got = rng_pcg.uniform_pcg_coords(seed, ctr, n, torch.from_numpy(px), torch.from_numpy(py))
    assert len(got) == n
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("row0,col0", [(0, 0), (37, 5)])
def test_uniform_pcg_window_bit_exact(row0, col0):
    for seed, ctr in ((147926525, 0), (-99, 4)):
        want = jrng.uniform_pcg(jnp.int32(seed), ctr, 6, 8, 12, row0=row0, col0=col0)
        got = rng_pcg.uniform_pcg(seed, ctr, 6, 8, 12, row0=row0, col0=col0)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# --- scene -----------------------------------------------------------------

@pytest.mark.parametrize("name", SCENES)
def test_scene_carried_across_equals_build(name, pair):
    js, carried = pair[name]
    mine = getattr(scenes, name)(device="cpu")
    jarrays = jax_scene_arrays(js)
    for field in TENSOR_FIELDS:
        a, b = getattr(mine, field), getattr(carried, field)
        assert a.dtype == b.dtype and a.device.type == "cpu", field
        assert torch.equal(a, b), field
        np.testing.assert_array_equal(a.numpy(), jarrays[field], err_msg=field)
    assert mine.has_dielectric == carried.has_dielectric == js.has_dielectric
    assert mine.n_tri_slot_lights == carried.n_tri_slot_lights == js.n_tri_slot_lights


def test_glass_cornell_matches_jax():
    js = jscenes.cornell_box(glass=True)
    mine = scenes.cornell_box(glass=True, device="cpu")
    assert mine.has_dielectric and js.has_dielectric
    for field, want in jax_scene_arrays(js).items():
        np.testing.assert_array_equal(getattr(mine, field).numpy(), want, err_msg=field)


# --- wavefront stages --------------------------------------------------------

def _planes(rs, lo, hi, normalize=False):
    a = rs.uniform(lo, hi, (3,) + N).astype(np.float32)
    if normalize:
        a = (a / np.linalg.norm(a, axis=0)).astype(np.float32)
    return a


def _j(v):
    return tuple(jnp.asarray(c) for c in v)


def _t(v):
    return tuple(torch.from_numpy(np.array(c)) for c in v)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **STAGE_TOL)


@pytest.mark.parametrize("row0", [0, 5])
def test_camera_rays_match(row0):
    rs = np.random.default_rng(row0)
    u1, u2 = rs.random((2,) + N, dtype=np.float32)
    pos = np.array([0.3, -1.0, 0.5], np.float32)
    quat = np.array([0.1, -0.2, 0.05, 0.97], np.float32)
    quat /= np.linalg.norm(quat)
    jcfg = JPTConfig(width=N[1], height=N[0] + 8, rng="pcg")
    cfg = PTConfig(width=N[1], height=N[0] + 8, rng="pcg")
    jo, jd = jwf._camera_rays(jcfg, jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(u1),
                              jnp.asarray(u2), row0=row0)
    o, d = wavefront._camera_rays(cfg, torch.from_numpy(pos), torch.from_numpy(quat),
                                  torch.from_numpy(u1), torch.from_numpy(u2), row0=row0)
    for k in range(3):
        _close(o[k].numpy(), jo[k], f"o[{k}]")
        _close(d[k].numpy(), jd[k], f"d[{k}]")


@pytest.mark.parametrize("name", ["material_spheres", "cornell_box"])
def test_sphere_and_triangle_hits_match(name, pair):
    js, ts = pair[name]
    rs = np.random.default_rng(7)
    o = _planes(rs, -1.0, 1.0) + np.array([0.0, 1.5, 0.0], np.float32)[:, None, None]
    d = _planes(rs, -1.0, 1.0, normalize=True)
    counts = wavefront._counts(ts)
    jt, ji = jwf._sphere_hits(js, _j(o), _j(d), 1e-3)
    t, i = wavefront._sphere_hits(ts, _t(o), _t(d), 1e-3, counts[0])
    _close(t.numpy(), jt, "sphere t")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i.numpy() >= 0).any()
    jt, ji = jwf._tri_hits_unrolled(js, _j(o), _j(d), 1e-3)
    t, i = wavefront._tri_hits_unrolled(ts, _t(o), _t(d), 1e-3, counts[1])
    _close(t.numpy(), jt, "triangle t")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if name == "cornell_box":
        assert (i.numpy() >= 0).mean() > 0.5


@pytest.mark.parametrize("name", ["material_spheres", "cornell_box"])
def test_intersect_matches(name, pair):
    js, ts = pair[name]
    rs = np.random.default_rng(11)
    o = _planes(rs, -1.0, 1.0) + np.array([0.0, 1.5, 0.0], np.float32)[:, None, None]
    d = _planes(rs, -1.0, 1.0, normalize=True)
    want = jwf._intersect(js, _j(o), _j(d), 1e-3, None)
    got = wavefront._intersect(ts, _t(o), _t(d), 1e-3, wavefront._counts(ts))
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for key in ("is_tri", "front", "mat_id"):
        np.testing.assert_array_equal(got[key].numpy()[hit], np.asarray(want[key])[hit], key)
    for key in ("t", "light_area"):
        _close(got[key].numpy()[hit], np.asarray(want[key])[hit], key)
    for k in range(3):
        _close(got["p"][k].numpy()[hit], np.asarray(want["p"][k])[hit], f"p[{k}]")
        _close(got["n"][k].numpy()[hit], np.asarray(want["n"][k])[hit], f"n[{k}]")


@pytest.mark.parametrize("name", ["material_spheres", "cornell_box"])
@pytest.mark.parametrize("uniform", [False, True])
def test_sample_light_matches(name, uniform, pair):
    js, ts = pair[name]
    rs = np.random.default_rng(3)
    u_sel, u1, u2 = rs.random((3,) + N, dtype=np.float32)
    want = jwf._sample_light(js, jnp.asarray(u_sel), jnp.asarray(u1), jnp.asarray(u2),
                             uniform=uniform)
    got = wavefront._sample_light(ts, torch.from_numpy(u_sel), torch.from_numpy(u1),
                                  torch.from_numpy(u2), int(ts.light_count), uniform=uniform)
    for a in range(3):
        for v, (g, w) in enumerate(zip(got[:3], want[:3])):
            _close(g[a].numpy(), w[a], f"output {v} axis {a}")
    _close(got[3].numpy(), want[3], "pdf_area")


@pytest.mark.parametrize("name", ["material_spheres", "cornell_box"])
def test_occluded_matches(name, pair):
    js, ts = pair[name]
    rs = np.random.default_rng(5)
    o = _planes(rs, -1.5, 1.5) + np.array([0.0, 2.0, 0.0], np.float32)[:, None, None]
    d = _planes(rs, -1.0, 1.0, normalize=True)
    max_t = rs.uniform(0.1, 4.0, N).astype(np.float32)
    want = jwf._occluded(js, _j(o), _j(d), jnp.asarray(max_t), 1e-3, None)
    got = wavefront._occluded(ts, _t(o), _t(d), torch.from_numpy(max_t), 1e-3,
                              wavefront._counts(ts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


# --- the device rule and the slice's bounds -----------------------------------

CONSTRUCTORS = {
    "default_scene": lambda: rtt.default_scene(),
    "make_scene": lambda: make_scene([((0, 4, 0), 1.0)], [{"color": (1, 0, 0)}],
                                     [((0, 0, 5), (1, 1, 1))]),
    "scene_from_numpy": lambda: scene_from_numpy(
        {f.name: np.asarray(getattr(rtt.default_scene("cpu"), f.name))
         for f in dataclasses.fields(rtt.Scene)}),
    "build_pt_scene": lambda: build_pt_scene(spheres=[((0, 4, 0), 1.0, 0)],
                                             materials=[{"albedo": (0.5,) * 3}]),
    "pt_scene_from_numpy": lambda: pt_scene_from_numpy(
        {k: v.numpy() for k, v in scenes.furnace_scene(device="cpu").tensors().items()}),
    "furnace_scene": lambda: scenes.furnace_scene(),
    "cornell_box": lambda: scenes.cornell_box(),
    "material_spheres": lambda: scenes.material_spheres(),
    "ProgressiveState.start": lambda: ProgressiveState.start(
        PTConfig(width=4, height=4), [0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_without_device_needs_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONSTRUCTORS[name]()


def test_load_checkpoint_without_device_needs_cuda(tmp_path, monkeypatch):
    from raytracing_engine_tpu_torch.runtime import save_checkpoint

    st = ProgressiveState.start(PTConfig(width=4, height=2), [0.0] * 3, [0, 0, 0, 1.0], key=3,
                                device="cpu")
    path = str(tmp_path / "st.npz")
    save_checkpoint(path, st)
    assert load_checkpoint(path, device="cpu").seed == rng_pcg.seed_from_int(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)


# The scene inputs that each stood for a feature still to port, every one now
# ported: each case keeps its name and builds, beside the feature it stood
# for, one of the light features (mesh lights per pass or per lane, the light
# tree). TRI, a unit triangle at slot 0 with the emissive material 1.
TRI = dict(triangles=np.eye(3, dtype=np.float32)[None], tri_mats=[1])
LIT = {"albedo": (0.0,) * 3, "emission": (3.0, 2.0, 1.0)}
NORMAL = np.broadcast_to(np.float32([0.6, 0.4, 0.9]), (2, 2, 3)).copy()
UNSUPPORTED_SCENES = {
    "env": dict(TRI, env=np.ones((4, 8, 3), np.float32), mesh_lights="lane"),  # the env map
    "tri_uvs": dict(TRI, tri_uvs=np.float32([[[0, 0], [1, 0], [0, 1]]]), mesh_lights=True,
                    materials=[{"albedo": (0.5,) * 3, "normal": NORMAL}, LIT]),
    "light_tree": dict(light_tree=2),
    "mesh_lights": dict(TRI, mesh_lights=True),
    "checker": dict(TRI, tri_uvs=np.float32([[[0, 0], [1, 0], [0, 1]]]), tex_mips=True,
                    light_tree=2,
                    materials=[{"albedo": (0.5,) * 3, "checker": {"scale": 2.0, "space": "uv"}},
                               LIT]),
    "image": dict(TRI, materials=[{"image": np.full((2, 2, 3), 0.3, np.float32)}, LIT],
                  tex_mips=True, mesh_lights=True),
    "normal": dict(materials=[{"albedo": (0.5,) * 3, "normal": NORMAL}, LIT], light_tree=2),
    "metal": dict(TRI, mesh_lights="lane",
                  materials=[{"albedo": (0.5,) * 3, "kind": METAL}, LIT]),
    "dispersion": dict(TRI, materials=[{"kind": DIELECTRIC, "roughness": 0.2, "dispersion": 0.02,
                                        "normal": NORMAL}, LIT], mesh_lights=True),
    "rough_dielectric": dict(materials=[{"kind": DIELECTRIC, "roughness": 0.2}, LIT],
                             light_tree=2),
    "tex_mips": dict(tex_mips=True, light_tree=2),
}


def assert_scene_matches_jax(got, js):
    """Every field of the port's PTScene equal to the JAX PTScene's, bit for
    bit; None where JAX has None, and the static flags alike."""
    for f in dataclasses.fields(js):
        want, have = getattr(js, f.name), getattr(got, f.name)
        if want is None or isinstance(want, (bool, int)):
            assert have == want, f.name
        else:
            np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=f.name)


@pytest.mark.parametrize("name", sorted(UNSUPPORTED_SCENES))
def test_unported_scene_inputs_raise(name):
    """The inputs build the JAX package's scene, field for field (the name
    stays from when they raised NotImplementedError)."""
    from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene

    kw = dict(spheres=[((0, 4, 0), 1.0, 0), ((2.0, 6.0, 1.0), 0.5, 1)],
              materials=[{"albedo": (0.5,) * 3}, LIT])
    kw.update(UNSUPPORTED_SCENES[name])
    js = jax_build_pt_scene(**kw)
    assert js.has_mesh_light or js.has_lane_mesh_light or js.has_light_tree
    assert_scene_matches_jax(build_pt_scene(device="cpu", **kw), js)


def test_unported_jax_fields_raise():
    """A JAX scene with the light tree's and the lane mesh lights' tables
    carries across field for field (the name stays from when they raised)."""
    from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene

    for kw in (UNSUPPORTED_SCENES["light_tree"], UNSUPPORTED_SCENES["metal"],
               UNSUPPORTED_SCENES["mesh_lights"]):
        kw = dict(dict(spheres=[((0, 4, 0), 1.0, 0), ((2.0, 6.0, 1.0), 0.5, 1)],
                       materials=[{"albedo": (0.5,) * 3}, LIT]), **kw)
        js = jax_build_pt_scene(**kw)
        assert_scene_matches_jax(pt_scene_from_numpy(jax_scene_arrays(js), device="cpu"), js)


# the configurations that each stood for a feature still to port: each
# renders a scene that has the feature's tables, equal to JAX's
# render_pt_fast at 4x4 within JAX's cross-engine bound
# (tests/test_mesh_lights.py:128-129), the ray counts equal
UNSUPPORTED_CONFIGS = {
    "fog": dict(fog_density=0.1),
    "tree": dict(light_sampling="tree"),
    "trilinear_tree": dict(tex_filter="trilinear", light_sampling="tree"),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED_CONFIGS))
def test_unported_config_gates_raise(name):
    """(The name stays from when these configurations raised.)"""
    from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene

    kw = dict(spheres=[((0.0, 4.0, 0.0), 1.0, 0), ((1.5, 5.0, 1.5), 0.5, 1),
                       ((0.0, 4.0, -51.0), 50.0, 0)],
              materials=[{"albedo": (0.6, 0.5, 0.4),
                          "image": np.linspace(0.1, 0.9, 48, dtype=np.float32).reshape(4, 4, 3)},
                         LIT], light_tree=2, tex_mips=True)
    cfg = dict(width=4, height=4, max_bounces=2, rng="pcg", **UNSUPPORTED_CONFIGS[name])
    want, n_want = jwf.render_pt_fast(JPTConfig(**cfg), jax_build_pt_scene(**kw), jnp.zeros(3),
                                      jnp.asarray([0.0, 0.0, 0.0, 1.0]), 2,
                                      jax.random.PRNGKey(3))
    got, n = wavefront.render_pt_fast(PTConfig(**cfg), build_pt_scene(device="cpu", **kw),
                                      torch.zeros(3), torch.tensor([0, 0, 0, 1.0]), 2, key=3)
    assert got.mean() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    assert int(n) == int(n_want)


def test_pt_args_mirror_the_cuda_struct():
    """ops/cuda/pt.PTArgs lists the fields of pt::Args in order."""
    src = (common.CSRC_DIR / "pt.cuh").read_text()
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    assert re.findall(r"(\w+)\s*[,;]", body) == [f for f, _ in pt.PTArgs._fields_]


def test_rebin_tile_is_the_k5_block():
    """The tile_oct regroup key groups ranks by K5's block (csrc/pt_body.cuh
    kRebinThreads), which the wrapper mirrors as REBIN_TILE."""
    src = (common.CSRC_DIR / "pt_body.cuh").read_text()
    assert int(re.search(r"constexpr int kRebinThreads = (\d+);", src).group(1)) == pt.REBIN_TILE


def test_mesh_kind_picks_the_k4_instantiation():
    """Each scene kind maps to its K4 instantiation (ops/cuda/pt.mesh_kind:
    none, a ClusterSet, instances of one), named in MESH_KINDS in the order
    csrc/pt.cuh numbers them; the sources of csrc/pt.cu's pt_render and
    csrc/pt_lights.cu's pt_lights_render (read as text: nothing is launched
    here) pick each by mesh_kind's rule, from the tables being null or
    not."""
    from raytracing_engine_tpu_torch.accel import (
        build_bvh,
        build_clusters,
        grid_instances,
        make_instanced_clusters,
        torus_knot,
    )

    src = (common.CSRC_DIR / "pt.cuh").read_text()
    kinds = {k: int(v) for k, v in re.findall(r"constexpr int kMesh(\w+) = (-?\d+);", src)}
    assert kinds == {"None": 0, "Clusters": 1, "Instances": 2, "Any": -1}
    assert [k.lower() for k, v in sorted(kinds.items(), key=lambda kv: kv[1]) if v >= 0] == list(
        pt.MESH_KINDS)
    for source, entry, fn in (("pt.cu", "pt_render", "launch_pt"),
                              ("pt_lights.cu", "pt_lights_render", "launch_pt_lights")):
        launch = (common.CSRC_DIR / source).read_text()
        body = re.search(rf"extern \"C\" int {entry}\(.*?\n\}}", launch, re.S).group(0)
        picks = re.findall(rf"if \(a->(\w+\.\w+) == nullptr\) (?:\{{\s*)?return [^;]*{fn}"
                           r"<pt::kMesh(\w+)>", body)
        assert picks == [("cl.trec", "None"), ("inst.tab", "Clusters")]
        assert re.findall(rf"{fn}<pt::kMesh(\w+)>", body) == ["None", "Clusters", "Instances"]
    assert list(pt.mesh_launches) == list(pt.MESH_KINDS)

    tris = torus_knot(segments=16, sides=8)
    cs = build_clusters(tris, device="cpu")
    inst = grid_instances(build_bvh(tris, device="cpu"), nx=2, ny=1, device="cpu")
    ic = make_instanced_clusters(inst, cs, device="cpu")
    cam = torch.zeros(3)
    assert pt.mesh_kind(pt.frame_view(None, cam)) == "none"
    assert pt.mesh_kind(pt.frame_view(cs, cam)) == "clusters"
    assert pt.mesh_kind(pt.frame_view(ic, cam)) == "instances"


def test_every_library_has_its_source():
    for name, (source, entries) in common.LIBRARIES.items():
        text = (common.CSRC_DIR / source).read_text()
        for entry in entries + (f"{name}_error_string",):
            assert f'extern "C"' in text and f" {entry}(" in text, entry
