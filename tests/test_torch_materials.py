"""The port's material features (GGX metal, anisotropic metal, the world
checker, spectral dispersion, the gradient sky) against the JAX package on
the CPU, inputs made from numpy seeds.

- the eight GGX functions of pathtracer/sampler.py on 4096 seeded inputs,
  within rtol 1e-6 / atol 1e-7;
- one "materials" scene built in both packages from the same list (a
  world-checkered floor, an isotropic and an anisotropic metal sphere, a
  dispersive glass sphere, an emissive sphere, a gradient sky): its arrays
  equal JAX's, and pt_scene_from_numpy of JAX's arrays equals the port's
  build;
- the plain render_pt_fast and render_pt_mega (the K4 wrapper on CPU
  tensors: its plain version, launching nothing) against JAX's
  render_pt_fast(rng="pcg") at 32x16, 3 bounces, 2 spp, within the bounds
  of tests/test_megakernel.py:37-40;
- the plain rebin route (K5's) equals the plain megakernel bit for bit on
  the scene with a mesh, through the 18-plane state (chan);
- dispersion 0 and a checker of scale 0 render bit for bit as the scene
  without them, also where the column is present and zero;
- render_aovs' albedo follows the checker as JAX's does.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels' material instantiations
need the card: chip_smoke.py phase 19 holds them to these plain versions.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.pathtracer import aov as jax_aov
from raytracing_engine_tpu.pathtracer import sampler as jsampler
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import (
    DIELECTRIC,
    METAL,
    PTConfig,
    build_pt_scene,
    pt_scene_from_numpy,
    render_aovs,
    sampler,
    wavefront,
)
from raytracing_engine_tpu_torch.pathtracer.scene import OPTIONAL_FIELDS, TENSOR_FIELDS

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=3)
POS = (0.0, -1.5, 1.8)
QUAT = (-0.109778, 0.0, 0.0, 0.993956)  # examples/showcase.json's camera
GGX_TOL = dict(rtol=1e-6, atol=1e-7)
AOV_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = TENSOR_FIELDS + OPTIONAL_FIELDS


def materials(checker=1.0, dispersion=0.08):
    """The materials scene's build_pt_scene arguments (both packages)."""
    mats = [
        {"albedo": (0.8, 0.75, 0.7), "checker": {"color": (0.15, 0.2, 0.3), "scale": checker}},
        {"albedo": (0.95, 0.75, 0.35), "kind": METAL, "roughness": 0.2},
        {"albedo": (0.7, 0.8, 0.9), "kind": METAL, "roughness": 0.15, "roughness_y": 0.5},
        {"kind": DIELECTRIC, "ior": 1.5, "dispersion": dispersion},
        {"albedo": (0.0, 0.0, 0.0), "emission": (25.0, 24.0, 22.0)},
    ]
    spheres = [((0.0, 8.0, -1001.0), 1000.0, 0), ((-2.5, 7.0, 0.2), 1.0, 1),
               ((2.6, 7.0, -0.2), 0.9, 2), ((0.0, 6.0, 0.2), 1.2, 3), ((4.0, 3.0, 4.0), 0.8, 4)]
    return dict(spheres=spheres, materials=mats, env=((0.15, 0.15, 0.2), (0.5, 0.65, 0.95)))


def jax_arrays(jscene) -> dict:
    return {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)
            if getattr(jscene, f.name) is not None
            and not isinstance(getattr(jscene, f.name), (bool, int))}


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


@pytest.fixture(scope="module")
def jax_side():
    """JAX's materials scene, its render_pt_fast (pcg, PRNGKey(13)) and its
    AOVs (2 spp, PRNGKey(5)): one compile each."""
    jscene = jax_build_pt_scene(**materials())
    pos, quat = jnp.asarray(POS), jnp.asarray(QUAT)
    img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), jscene, pos, quat, 2,
                                jax.random.PRNGKey(13))
    aovs = jax_aov.render_aovs(JPTConfig(**SIZE), jscene, pos, quat, 2, jax.random.PRNGKey(5))
    return dict(scene=jscene, arrays=jax_arrays(jscene), img=np.array(img), n=float(n),
                aovs={k: np.asarray(v) for k, v in aovs.items()})


def test_ggx_functions_match_jax(monkeypatch):
    """ggx_d, ggx_smith_g1, sample_ggx_h, ggx_eval and their anisotropic
    four on 4096 seeded inputs (wo above the surface, wi anywhere), within
    rtol 1e-6 / atol 1e-7 with a correctly rounded square root. PyTorch's
    float32 sqrt on the CPU is not correctly rounded (about 0.6% of random
    inputs off by one bit; XLA's is exact), and sample_ggx_h's
    sqrt(1 - cos_h²) magnifies that bit where cos_h nears 1: with
    torch.sqrt itself at most 1e-3 of the elements leave the tolerance, and
    by at most 1e-5."""
    rng = np.random.default_rng(7)
    k = 4096

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    n = unit(rng.normal(size=(k, 3)))
    wo = unit(rng.normal(size=(k, 3)))
    wo = np.where((wo * n).sum(1, keepdims=True) < 0, -wo, wo)
    wi = unit(rng.normal(size=(k, 3)))
    f0 = rng.uniform(0.0, 1.0, (k, 3)).astype(np.float32)
    ax, ay = (rng.uniform(0.05, 1.0, k).astype(np.float32) ** 2 for _ in range(2))
    u1, u2, c = (rng.uniform(0.0, 1.0, k).astype(np.float32) for _ in range(3))

    def planes(a):
        return tuple(a[:, i] for i in range(3))

    def run(mod, cast):
        V = lambda a: tuple(cast(x) for x in planes(a))  # noqa: E731
        nn, o, i, f = V(n), V(wo), V(wi), V(f0)
        t, s = mod.build_onb(nn)
        dotp = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]  # noqa: E731
        h, cos_h = mod.sample_ggx_h(cast(u1), cast(u2), nn, cast(ax))
        f_iso, pdf_iso = mod.ggx_eval(nn, o, i, f, cast(ax))
        f_an, pdf_an = mod.ggx_eval_aniso(nn, t, s, o, i, f, cast(ax), cast(ay))
        ox, oy, oz = dotp(o, t), dotp(o, s), dotp(o, nn)
        out = {
            "ggx_d": mod.ggx_d(cast(c), cast(ax)),
            "ggx_smith_g1": mod.ggx_smith_g1(cast(c), cast(ax)),
            "sample_ggx_h": (*h, cos_h),
            "ggx_eval": (*f_iso, pdf_iso),
            "ggx_d_aniso": mod.ggx_d_aniso(cast(u1) - 0.5, cast(u2) - 0.5, cast(c), cast(ax),
                                           cast(ay)),
            "ggx_smith_g1_aniso": mod.ggx_smith_g1_aniso(ox, oy, oz, cast(ax), cast(ay)),
            "sample_ggx_h_aniso": mod.sample_ggx_h_aniso(cast(u1), cast(u2), t, s, nn, cast(ax),
                                                         cast(ay)),
            "ggx_eval_aniso": (*f_an, pdf_an),
        }
        return {key: np.stack([np.asarray(x) for x in (v if isinstance(v, tuple) else (v,))])
                for key, v in out.items()}

    want = run(jsampler, jnp.asarray)
    native = run(sampler, torch.from_numpy)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    got = run(sampler, torch.from_numpy)
    assert list(got) == list(want) == list(native) and len(got) == 8
    for key in want:
        assert np.isfinite(got[key]).all() and np.isfinite(native[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **GGX_TOL)
        off = ~np.isclose(native[key], want[key], **GGX_TOL)
        assert off.mean() <= 1e-3, (key, off.mean())
        np.testing.assert_allclose(native[key], want[key], rtol=0.0, atol=1e-5, err_msg=key)
    # both branches of the masks ran: valid and under-surface samples
    assert 0.2 < (want["ggx_eval"][3] > 0).mean() < 0.8


def test_materials_scene_matches_jax(jax_side):
    """The port's build equals JAX's array for array (the optional columns
    where JAX has them), and so does pt_scene_from_numpy of JAX's arrays;
    the static gates agree."""
    port = build_pt_scene(device=CPU, **materials())
    js = jax_side["scene"]
    assert_same_scene(port, jax_side["arrays"])
    assert_same_scene(pt_scene_from_numpy(jax_side["arrays"], device=CPU), jax_side["arrays"])
    for flag in ("has_metal", "has_aniso", "has_texture", "has_dispersion", "has_env",
                 "has_dielectric"):
        assert getattr(port, flag) == getattr(js, flag) is True, flag
    assert wavefront.state_plane_count(port) == 18
    assert port.has_material_features
    sph, tri, mat, light, counts, env = pt.pack_pt_scene(port)
    # JAX's fixed column order: base 8, albedo2 + scale, rough, rough2, dispersion, pad
    assert mat.shape == (5, 16)
    np.testing.assert_array_equal(mat[:, 12].numpy(), jax_side["arrays"]["mat_rough"])
    np.testing.assert_array_equal(mat[:, 14].numpy(), jax_side["arrays"]["mat_dispersion"])
    np.testing.assert_array_equal(env[:, :3].numpy(), jax_side["arrays"]["env"])


def test_renders_match_jax(jax_side):
    """The plain render_pt_fast and render_pt_mega against JAX's
    render_pt_fast at 32x16, 3 bounces, 2 spp."""
    scene = build_pt_scene(device=CPU, **materials())
    cfg = PTConfig(**SIZE, rng="pcg")
    want, n_want = jax_side["img"], jax_side["n"]
    fast, n_fast = wavefront.render_pt_fast(cfg, scene, *cam(), 2, seed=seed_from_int(13))
    mega, n_mega = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(13))
    for got, n in ((fast, n_fast), (mega, n_mega)):
        assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
        hold_megakernel_bounds(got.numpy(), n, want, n_want)
    assert 0.05 < want.mean() < 5.0


def test_mega_wrapper_on_cpu_is_its_plain_version():
    scene = build_pt_scene(device=CPU, **materials())
    cfg = PTConfig(**SIZE, rng="pcg")
    before = (pt.launches, dict(pt.material_launches), pt.rebin_launches)
    got, n = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(3), row0=4, band_h=8)
    want, n_want = pt.render_pt_mega_reference(cfg, scene, *cam(), 2, seed=seed_from_int(3),
                                               row0=4, band_h=8)
    assert torch.equal(got, want) and int(n) == int(n_want)
    assert (pt.launches, dict(pt.material_launches), pt.rebin_launches) == before


def mesh_scene(**kw):
    """The materials scene with a diffuse icosphere (a ClusterSet)."""
    tris = icosphere(subdivisions=1, radius=0.9, center=(2.6, 9.0, 1.5))
    args = materials(**kw)
    args["materials"] = args["materials"] + [{"albedo": (0.7, 0.3, 0.2)}]
    mats = np.full(len(tris), len(args["materials"]) - 1, np.int32)
    scene = build_pt_scene(device=CPU, triangles=tris, tri_mats=mats, **args)
    return scene, build_clusters(tris, tri_mats=mats, device=CPU)


def test_rebin_route_equals_megakernel_with_chan():
    """K5's plain route (one staged bounce per call over the 18-plane state,
    regrouped between bounces) equals the plain megakernel bit for bit."""
    scene, cs = mesh_scene()
    cfg = PTConfig(width=24, height=12, max_bounces=3, rng="pcg")
    mega, n_mega = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(5), bvh=cs)
    for rebin in ("none,morton", "oct,tile_oct"):
        got, n = pt.render_pt_rebin(cfg, scene, *cam(), 2, seed=seed_from_int(5), bvh=cs,
                                    rebin=rebin)
        assert torch.equal(got, mega) and int(n) == int(n_mega), rebin
    st = wavefront.trace_window_planes(cfg, pt.kernel_scene(scene, cs), *cam(),
                                       seed_from_int(5), emit_state=True,
                                       bvh=pt.frame_view(cs, cam()[0]))
    packed = wavefront.pack_state(st)
    assert packed.shape == (18, 12, 24)
    assert torch.equal(wavefront.pack_state(wavefront.unpack_state(packed, has_chan=True)),
                       packed)
    chan = packed[17]
    assert ((chan == -1.0) | (chan == 0.0) | (chan == 1.0) | (chan == 2.0)).all()
    assert (chan >= 0).any()  # some paths committed to a channel
    assert mega.mean() > 0


def test_zero_dispersion_and_zero_checker_change_nothing():
    """dispersion 0 and a checker of scale 0 drop their columns, as in the
    JAX package; present and all zero, the columns render the same, bit for
    bit, through the megakernel's and the rebin route's plain versions."""
    cfg = PTConfig(**SIZE, rng="pcg")
    plain = build_pt_scene(device=CPU, **materials(checker=0.0, dispersion=0.0))
    assert not plain.has_dispersion and not plain.has_texture
    keyless = materials(checker=0.0, dispersion=0.0)
    for m in keyless["materials"]:
        m.pop("dispersion", None)
        m.pop("checker", None)
    assert_same_scene(build_pt_scene(device=CPU, **keyless),
                      {k: getattr(plain, k).numpy() for k in FIELDS
                       if getattr(plain, k) is not None})
    M = plain.mat_albedo.shape[0]
    zero = torch.zeros(M)
    disp0 = dataclasses.replace(plain, mat_dispersion=zero)
    check0 = dataclasses.replace(plain, mat_albedo2=torch.full((M, 3), 0.5), mat_tex_scale=zero)
    assert disp0.has_dispersion and check0.has_texture
    want, n_want = pt.render_pt_mega(cfg, plain, *cam(), 2, seed=seed_from_int(9))
    for scene in (disp0, check0):
        got, n = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(9))
        assert torch.equal(got, want) and int(n) == int(n_want)
    mesh_plain, cs = mesh_scene(checker=0.0, dispersion=0.0)
    mesh_disp0 = dataclasses.replace(mesh_plain, mat_dispersion=torch.zeros(M + 1))
    small = PTConfig(width=16, height=8, max_bounces=2, rng="pcg")
    a, _ = pt.render_pt_rebin(small, mesh_plain, *cam(), 1, seed=seed_from_int(9), bvh=cs)
    b, _ = pt.render_pt_rebin(small, mesh_disp0, *cam(), 1, seed=seed_from_int(9), bvh=cs)
    assert torch.equal(a, b)


def test_aov_albedo_follows_the_checker(jax_side):
    """render_aovs' albedo (2 spp) against JAX's on the checkered floor: hit
    flags equal and the planes within atol / rtol 1e-5 but for at most 1e-3
    of the pixels (rounded up to a whole pixel); both checker colors seen."""
    scene = build_pt_scene(device=CPU, **materials())
    got = render_aovs(PTConfig(**SIZE), scene, *cam(), 2, 5)
    want = jax_side["aovs"]
    bad = (got["depth"].numpy() > 0) != (want["depth"] > 0)
    for k in ("albedo", "normal", "depth"):
        off = ~np.isclose(got[k].numpy(), want[k], **AOV_TOL)
        bad |= off.any(-1) if off.ndim == 3 else off
    assert bad.sum() <= math.ceil(1e-3 * bad.size), np.argwhere(bad).tolist()
    alb = want["albedo"].reshape(-1, 3)
    for color in ((0.8, 0.75, 0.7), (0.15, 0.2, 0.3)):
        assert (np.abs(alb - color).max(-1) < 1e-6).any(), color
