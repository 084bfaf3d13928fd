"""The port's mip chains and trilinear filtering (pathtracer/scene.py
build_mip_chain and build_pt_scene(tex_mips=True), pathtracer/wavefront.py
_mip_lod_footprint, _sample_rect_tri and the ray cone's `tacc` state)
against the JAX package on the CPU, inputs made from numpy seeds.

- build_mip_chain (odd sides included) and the scene's atlas and
  mat_tex_mips (short chains repeating their 1 x 1 level) bit for bit JAX's;
- _mip_lod_footprint and _sample_rect_tri on seeded inputs within rtol 1e-6
  / atol 1e-7, with a correctly rounded square root (PyTorch's float32 sqrt
  on the CPU is not; XLA's is);
- state_plane_count and pack_state / unpack_state(has_tacc=) equal JAX's;
- one trilinear scene (an image sphere and a UV icosphere, each with an
  image and a normal map, sampled bilinearly under "trilinear", a world
  checker; 32x16, 2 bounces, 2 spp) through the plain render_pt_fast and
  render_pt_mega, with the icosphere as a ClusterSet and as a rotated
  instance, against JAX's render_pt_fast (its jnp stacked path, one
  compile) within tests/test_megakernel.py:37-40's bounds, the rebin route
  bit for bit with the megakernel;
- the mipped scene under "nearest" and "bilinear" renders bit for bit the
  unmipped one;
- a JSON scene with "tex_mips": true loads to JAX's arrays; "trilinear"
  without mip chains raises JAX's ValueError.

Six tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels' branches need the card:
chip_smoke.py phase 22 holds them to these plain versions.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import icosphere as jax_icosphere
from raytracing_engine_tpu.pathtracer import scene as jscene_mod
from raytracing_engine_tpu.pathtracer import wavefront as jwave
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json as jax_load

from raytracing_engine_tpu_torch.accel import (
    build_bvh,
    build_clusters,
    make_instanced_clusters,
    make_instances,
)
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import (
    PTConfig,
    build_pt_scene,
    load_scene_json,
    pt_scene_from_numpy,
    wavefront,
)
from raytracing_engine_tpu_torch.pathtracer import scene as scene_mod
from raytracing_engine_tpu_torch.pathtracer.scene import OPTIONAL_FIELDS, TENSOR_FIELDS

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=2)
POS = (0.0, -1.5, 1.8)
QUAT = (-0.109778, 0.0, 0.0, 0.993956)  # examples/showcase.json's camera
FN_TOL = dict(rtol=1e-6, atol=1e-7)
FIELDS = TENSOR_FIELDS + OPTIONAL_FIELDS
CENTER = (2.6, 9.0, 1.5)
BALL = dict(subdivisions=1, radius=0.9)
ANGLE = 0.6  # the instance's rotation about z


@contextlib.contextmanager
def correctly_rounded_sqrt():
    """torch.sqrt through float64 (correctly rounded for float32 inputs)."""
    sqrt = torch.sqrt
    torch.sqrt = lambda x: sqrt(x.double()).to(x.dtype)
    try:
        yield
    finally:
        torch.sqrt = sqrt


def images(seed=3):
    """(a 4 x 16 albedo image (5 levels), a 3 x 5 one (4 levels: a shorter
    chain), a 4 x 6 normal map holding (n + 1) / 2): one 4-row atlas shelf,
    which keeps JAX's per-fetch row chain, and its compile, short."""
    rng = np.random.default_rng(seed)
    n = rng.normal(0.0, 0.4, (4, 6, 3))
    n[..., 2] = 1.0
    return (rng.uniform(0.0, 1.0, (4, 16, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (3, 5, 3)).astype(np.float32),
            ((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1.0) * 0.5).astype(np.float32))


def spherical_uvs(tris, center):
    p = tris - np.asarray(center, np.float32)
    u = np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5
    v = np.arccos(np.clip(p[..., 2] / np.linalg.norm(p, axis=-1), -1.0, 1.0)) / np.pi
    return np.stack([u, v], -1).astype(np.float32)


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.float32([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def local_ball():
    ball = jax_icosphere(**BALL).astype(np.float32)
    return ball, spherical_uvs(ball, (0.0, 0.0, 0.0))


def scene_args(tex_mips=True):
    """The trilinear scene (both packages): a world-checkered floor (0), an
    image sphere tiled 4 times with a normal map (1), the icosphere's image
    and normal map (2), a sphere light (3), a small-image sphere (4); the
    icosphere rotated by ANGLE about z and moved to CENTER, 80 slots."""
    tex, small, nrm = images()
    mats = [{"albedo": (0.7, 0.7, 0.65), "checker": {"color": (0.2, 0.3, 0.4), "scale": 1.0}},
            {"image": {"pixels": tex, "scale": 4.0}, "normal": {"pixels": nrm, "scale": 2.0}},
            {"image": {"pixels": tex, "scale": 2.0}, "normal": nrm},
            {"albedo": (0.0, 0.0, 0.0), "emission": (20.0, 18.0, 15.0)},
            {"image": small}]
    spheres = [((0.0, 8.0, -1001.0), 1000.0, 0), ((-1.5, 6.0, 0.0), 1.0, 1),
               ((1.0, 7.0, 0.0), 0.8, 4), ((3.0, 4.0, 3.0), 0.5, 3)]
    ball, uvs = local_ball()
    world = ball @ rot_z(ANGLE).T + np.float32(CENTER)
    return dict(spheres=spheres, materials=mats, triangles=world,
                tri_mats=np.full(len(world), 2, np.int32), tri_uvs=uvs, tex_mips=tex_mips)


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


def port_meshes(args):
    """(the icosphere as a ClusterSet in world space, the scene without the
    triangles and the icosphere as an instance of its local UV set)."""
    cs = build_clusters(args["triangles"], tri_mats=args["tri_mats"], vertex_uvs=args["tri_uvs"],
                        device=CPU)
    ball, uvs = local_ball()
    inst = make_instances(build_bvh(ball, use_native=False, device=CPU),
                          [(rot_z(ANGLE), CENTER, 1.0)], mats=np.int32([2]), device=CPU)
    ic = make_instanced_clusters(inst, build_clusters(ball, vertex_uvs=uvs, device=CPU),
                                 device=CPU)
    iscene = build_pt_scene(device=CPU, **{k: v for k, v in args.items()
                                           if k not in ("triangles", "tri_mats", "tri_uvs")})
    return cs, iscene, ic


def test_build_mip_chain_and_tables_match_jax():
    """Chains of odd and even sides bit for bit; the scene's atlas, rects
    and per-level rect table (a 3 x 5 chain shorter than the 4 x 16 one
    repeats its 1 x 1 level) bit for bit; JAX's fields carry across."""
    rng = np.random.default_rng(8)
    for shape in ((12, 20), (5, 3), (1, 9), (7, 1), (3, 3), (16, 64), (1, 1)):
        img = rng.uniform(0.0, 2.0, shape + (3,)).astype(np.float32)
        got, want = scene_mod.build_mip_chain(img), jscene_mod.build_mip_chain(img)
        assert len(got) == len(want) and got[-1].shape[:2] == (1, 1)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    args = scene_args()
    js = jax_build_pt_scene(**args)
    scene = build_pt_scene(device=CPU, **args)
    want = jax_arrays(js)
    assert_same_scene(scene, want)
    assert scene.has_mips and scene.needs_tan and scene.n_mip_levels == js.n_mip_levels == 5
    mips = scene.mat_tex_mips.numpy().reshape(5, 5, 4)
    # the 3 x 5 chain has 4 levels (3 x 5, 2 x 3, 1 x 2, 1 x 1): its 1 x 1 repeats
    assert mips[4, 3, 2:].tolist() == [1.0, 1.0]
    assert mips[4, 4].tolist() == mips[4, 3].tolist()
    np.testing.assert_array_equal(mips[:, 0], scene.mat_tex_rect.numpy())
    assert_same_scene(pt_scene_from_numpy(want, device=CPU), want)
    unmipped = build_pt_scene(device=CPU, **dict(args, tex_mips=False))
    assert not unmipped.has_mips and unmipped.mat_tex_mips is None


def test_footprint_and_trilinear_fetch_match_jax():
    """_mip_lod_footprint on (64, 64) planes of seeded hits (spheres and
    triangles, grazing and head-on, tangents from 0 up) and _sample_rect_tri
    on seeded UVs, tilings, footprints (below one texel, across the chain,
    beyond its end) and materials (one without an image), within rtol 1e-6
    / atol 1e-7."""
    rng = np.random.default_rng(12)
    args = scene_args()
    js = jax_build_pt_scene(**args)
    scene = build_pt_scene(device=CPU, **args)
    shape = (64, 64)
    n = rng.normal(size=(3,) + shape)
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    d = rng.normal(size=(3,) + shape)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    d[:, :4] = n[:, :4]  # head-on
    tan = rng.normal(0.0, 1.0, (3,) + shape).astype(np.float32) * rng.uniform(
        0.0, 3.0, shape).astype(np.float32)
    tan[:, 4:6] = 0.0
    isect = dict(tan=tan, n=n, is_tri=rng.random(shape) < 0.5,
                 light_area=rng.uniform(0.5, 20.0, shape).astype(np.float32))
    tacc = rng.uniform(0.0, 40.0, shape).astype(np.float32)
    cfg = dict(width=320, height=160)

    def run(mod, cfg_cls, sc, cast):
        c = cfg_cls(**cfg, tex_filter="trilinear")
        isc = {k: tuple(cast(x) for x in v) if k in ("tan", "n") else cast(v)
               for k, v in isect.items()}
        return mod._mip_lod_footprint(c, sc, isc, tuple(cast(x) for x in d), cast(tacc))

    want = np.asarray(run(jwave, JPTConfig, js, jnp.asarray))
    with correctly_rounded_sqrt():
        got = run(wavefront, PTConfig, scene, torch.from_numpy).numpy()
    np.testing.assert_allclose(got, want, **FN_TOL)
    assert np.ptp(np.log2(np.maximum(want, 1e-12))) > 8

    mat = rng.integers(0, 5, shape).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (2,) + shape).astype(np.float32)
    s = rng.choice(np.float32([0.5, 1.0, 4.0]), shape)
    fp = np.exp(rng.uniform(-6.0, 2.0, shape)).astype(np.float32)
    want = jwave._sample_rect_tri(js, jnp.asarray(mat), tuple(jnp.asarray(x) for x in uv),
                                  jnp.asarray(s), jnp.asarray(fp))
    got = wavefront._sample_rect_tri(scene, torch.from_numpy(mat),
                                     tuple(torch.from_numpy(x) for x in uv), torch.from_numpy(s),
                                     torch.from_numpy(fp))
    got, want = np.stack([g.numpy() for g in got]), np.stack([np.asarray(w) for w in want])
    np.testing.assert_allclose(got, want, **FN_TOL)
    assert np.ptp(got) > 0.5


def test_state_planes_match_jax():
    """state_plane_count over dispersion x mips x filter, and pack_state /
    unpack_state(has_chan=, has_tacc=) of a seeded state equal JAX's."""
    rng = np.random.default_rng(2)
    args = scene_args()
    for mips in (False, True):
        for disp in (False, True):
            a = dict(args, tex_mips=mips)
            if disp:
                a["materials"] = a["materials"] + [{"kind": 3, "dispersion": 0.02}]
            js, sc = jax_build_pt_scene(**a), build_pt_scene(device=CPU, **a)
            for filt in ("nearest", "bilinear", "trilinear"):
                want = jwave.state_plane_count(js, JPTConfig(tex_filter=filt))
                got = wavefront.state_plane_count(sc, PTConfig(tex_filter=filt))
                assert got == want == 17 + disp + (mips and filt == "trilinear")
            assert wavefront.state_plane_count(sc) == jwave.state_plane_count(js) == 17 + disp
    shape = (4, 6)
    st = {k: tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))
          for k in ("o", "d", "thr", "rad")}
    st.update(alive=(rng.random(shape) < 0.5), prev_did_nee=(rng.random(shape) < 0.5),
              prev_pdf=rng.random(shape).astype(np.float32),
              px=rng.integers(0, 99, shape).astype(np.int32),
              py=rng.integers(0, 99, shape).astype(np.int32),
              chan=rng.integers(-1, 3, shape).astype(np.float32),
              tacc=rng.uniform(0.0, 9.0, shape).astype(np.float32))
    jst = {k: tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(
        v.astype(np.float32) if v.dtype == bool else v) for k, v in st.items()}
    tst = {k: tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple) else torch.from_numpy(v)
           for k, v in st.items()}
    want, got = np.asarray(jwave.pack_state(jst)), wavefront.pack_state(tst).numpy()
    assert got.shape == want.shape == (19,) + shape
    np.testing.assert_array_equal(got, want)
    back = wavefront.unpack_state(torch.from_numpy(got), has_chan=True, has_tacc=True)
    jback = jwave.unpack_state(jnp.asarray(want), True, has_tacc=True)
    for k in ("chan", "tacc", "prev_pdf"):
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    assert "tacc" not in wavefront.unpack_state(torch.from_numpy(got[:18]), has_chan=True)


def test_trilinear_renders_match_jax():
    """The trilinear, normal-mapped scene against JAX's jnp render_pt_fast:
    the port's render_pt_fast and render_pt_mega with the icosphere as a
    ClusterSet and as a rotated instance; the rebin route bit for bit with
    the megakernel; the mip chains and the normal maps each move the
    image."""
    args = scene_args()
    cfg = PTConfig(**SIZE, rng="pcg", tex_filter="trilinear")
    js = jax_build_pt_scene(**args)
    want, n_want = jwave.render_pt_fast(JPTConfig(**SIZE, rng="pcg", tex_filter="trilinear"),
                                        js, jnp.asarray(POS), jnp.asarray(QUAT), 2,
                                        jax.random.PRNGKey(13))
    want, n_want = np.asarray(want), float(n_want)
    assert 0.05 < want.mean() < 5.0
    scene = build_pt_scene(device=CPU, **args)
    cs, iscene, ic = port_meshes(args)
    kw = dict(seed=seed_from_int(13))
    for sc, mesh in ((scene, cs), (iscene, ic)):
        fast = wavefront.render_pt_fast(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        mega = pt.render_pt_mega(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        for got, n in (fast, mega):
            assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
            hold_megakernel_bounds(got.numpy(), n, want, n_want)
        rb = pt.render_pt_rebin(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        assert torch.equal(rb[0], mega[0]) and int(rb[1]) == int(mega[1])
    bil = pt.render_pt_mega(dataclasses.replace(cfg, tex_filter="bilinear"), scene, *cam(), 2,
                            bvh=cs, **kw)
    assert np.abs(bil[0].numpy() - want).max() > 1e-2  # the mip chain changes the image
    flat = dict(args, materials=[{k: v for k, v in m.items() if k != "normal"}
                                 for m in args["materials"]])
    unmapped = pt.render_pt_mega(cfg, build_pt_scene(device=CPU, **flat), *cam(), 2, bvh=cs,
                                 **kw)
    assert np.abs(unmapped[0].numpy() - want).max() > 1e-2  # so do the normal maps


def test_mipped_scene_under_nearest_and_bilinear_is_the_unmipped_one():
    """Level 0 of a chain is the image, and only "trilinear" reads the
    chain: with tex_mips the nearest and bilinear megakernel and rebin
    renders equal those without, bit for bit."""
    args = scene_args()
    cs, _, _ = port_meshes(args)
    kw = dict(seed=seed_from_int(4), bvh=cs)
    mipped = build_pt_scene(device=CPU, **args)
    plain = build_pt_scene(device=CPU, **dict(args, tex_mips=False))
    for filt in ("nearest", "bilinear"):
        cfg = PTConfig(**SIZE, rng="pcg", tex_filter=filt)
        a, na = pt.render_pt_mega(cfg, mipped, *cam(), 1, **kw)
        b, nb = pt.render_pt_mega(cfg, plain, *cam(), 1, **kw)
        assert torch.equal(a, b) and int(na) == int(nb)
        r, _ = pt.render_pt_rebin(cfg, mipped, *cam(), 1, **kw)
        assert torch.equal(r, b)
        assert wavefront.state_plane_count(mipped, cfg) == 17


def test_json_tex_mips_and_trilinear_without_mips(tmp_path):
    """"tex_mips": true in a JSON scene loads to JAX's arrays; "trilinear"
    on a scene without mip chains raises JAX's ValueError in every entry
    point."""
    tex, small, _ = images(6)
    np.save(str(tmp_path / "tex.npy"), tex)
    np.save(str(tmp_path / "small.npy"), small)
    spec = {"materials": [{"albedo": [0.6, 0.6, 0.6], "image": {"npy": "tex.npy", "scale": 2}},
                          {"albedo": [0.5, 0.5, 0.5], "image": {"npy": "small.npy"}},
                          {"albedo": [0, 0, 0], "emission": [9, 9, 9]}],
            "spheres": [{"center": [-1.5, 6, 0], "radius": 1, "mat": 1},
                        {"center": [1.5, 6, 0], "radius": 1, "mat": 0},
                        {"center": [3, 4, 3], "radius": 0.5, "mat": 2}],
            "tex_mips": True}
    path = str(tmp_path / "mips.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    got, want = load_scene_json(path, device="cpu"), jax_load(path)
    assert_same_scene(got.scene, jax_arrays(want.scene))
    assert got.scene.has_mips and got.scene.n_mip_levels == want.scene.n_mip_levels == 5

    del spec["tex_mips"]
    with open(path, "w") as f:
        json.dump(spec, f)
    scene, js = load_scene_json(path, device="cpu").scene, jax_load(path).scene
    with pytest.raises(ValueError) as e_jax:
        jwave.render_pt_fast(JPTConfig(width=8, height=4, tex_filter="trilinear"), js,
                             jnp.zeros(3), jnp.asarray(QUAT), 1, jax.random.PRNGKey(0))
    cfg = PTConfig(width=8, height=4, rng="pcg", tex_filter="trilinear")
    for fn in (wavefront.render_pt_fast, pt.render_pt_mega):
        with pytest.raises(ValueError) as e:
            fn(cfg, scene, torch.zeros(3), torch.tensor(QUAT), 1)
        assert str(e.value) == str(e_jax.value)
