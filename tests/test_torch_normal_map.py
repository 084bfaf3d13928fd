"""The port's tangent-space normal maps (pathtracer/scene.py's "normal"
material key, pathtracer/wavefront.py _perturb_normal and the hits'
texture-u tangent planes, ops/cuda/cluster.py and ops/cuda/instanced.py
with tan=True) against the JAX package on the CPU, inputs made from numpy
seeds.

- build_pt_scene with normal maps beside albedo images (one shared atlas):
  every table bit for bit JAX's, and pt_scene_from_numpy carrying JAX's
  mat_nrm_rect / mat_nrm_scale / mat_tex_mips;
- _perturb_normal (nearest and bilinear, degenerate tangents, flat texels,
  unmapped materials) on seeded inputs within rtol 1e-6 / atol 1e-7;
- the tangent planes the maps turn by: K6's on a UV table and K7's on a UV
  base table are held to the JAX package in tests/test_torch_cluster.py
  and tests/test_torch_instancing.py;
- one normal-mapped scene (spheres, a UV icosphere of 80 triangles; 32x16,
  2 bounces, 2 spp) with the icosphere as a ClusterSet and as a rotated
  instance: the rebin route bit for bit with the megakernel at nearest and
  bilinear (JAX's renders of normal maps: tests/test_torch_mips.py, which
  holds a normal-mapped trilinear scene to JAX's render_pt_fast);
- render_aovs' normal guide, the perturbed shading normal, against JAX's;
- a JSON scene with a "normal" npy map loads to JAX's arrays.

Six tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels' branches need the card:
chip_smoke.py phase 22 holds them to these plain versions.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import icosphere as jax_icosphere
from raytracing_engine_tpu.pathtracer import aov as jax_aov
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
    render_aovs,
    wavefront,
)
from raytracing_engine_tpu_torch.pathtracer.scene import OPTIONAL_FIELDS, TENSOR_FIELDS

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=2)
POS = (0.0, -1.5, 1.8)
QUAT = (-0.109778, 0.0, 0.0, 0.993956)  # examples/showcase.json's camera
FN_TOL = dict(rtol=1e-6, atol=1e-7)
# XLA contracts the intersection arithmetic into FMAs on the CPU (ROADMAP.md
# hazard 1): AOV hit points move by up to 3e-5 against the port's
AOV_TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = TENSOR_FIELDS + OPTIONAL_FIELDS
CENTER = (2.6, 9.0, 1.5)
BALL = dict(subdivisions=1, radius=0.9)
ANGLE = 0.6  # the instance's rotation about z


def maps(seed=5):
    """(albedo (6, 10, 3), normal map (8, 12, 3) holding (n + 1) / 2, a
    second normal map (4, 6, 3)) from a seed."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.0, 1.0, (6, 10, 3)).astype(np.float32)
    out = [tex]
    for shape in ((8, 12), (4, 6)):
        n = rng.normal(0.0, 0.4, shape + (3,))
        n[..., 2] = 1.0
        out.append(((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1.0) * 0.5)
                   .astype(np.float32))
    return tuple(out)


def spherical_uvs(tris, center):
    p = tris - np.asarray(center, np.float32)
    u = np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5
    v = np.arccos(np.clip(p[..., 2] / np.linalg.norm(p, axis=-1), -1.0, 1.0)) / np.pi
    return np.stack([u, v], -1).astype(np.float32)


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.float32([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def local_ball():
    """The icosphere around the origin with its spherical UVs."""
    ball = jax_icosphere(**BALL).astype(np.float32)
    return ball, spherical_uvs(ball, (0.0, 0.0, 0.0))


def scene_args(tex_mips=False):
    """The normal-mapped scene (both packages): a world-checkered floor (0),
    a normal-mapped sphere (1), the icosphere's image and normal map (2), a
    sphere light (3), an image sphere with a tiled normal map (4); the
    icosphere rotated by ANGLE about z and moved to CENTER, 80 slots."""
    tex, nrm, nrm2 = maps()
    mats = [{"albedo": (0.7, 0.7, 0.65), "checker": {"color": (0.2, 0.3, 0.4), "scale": 1.0}},
            {"albedo": (0.8, 0.3, 0.2), "normal": nrm2},
            {"image": {"pixels": tex, "scale": 2.0}, "normal": {"pixels": nrm, "scale": 1.0}},
            {"albedo": (0.0, 0.0, 0.0), "emission": (20.0, 18.0, 15.0)},
            {"image": tex, "normal": {"pixels": nrm, "scale": 2.0}}]
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


def port_meshes(args, scene):
    """The icosphere as a ClusterSet (world space) and as an instance of its
    local UV set, rotated by ANGLE about z and moved to CENTER."""
    cs = build_clusters(args["triangles"], tri_mats=args["tri_mats"], vertex_uvs=args["tri_uvs"],
                        device=CPU)
    ball, uvs = local_ball()
    base = build_clusters(ball, vertex_uvs=uvs, device=CPU)
    inst = make_instances(build_bvh(ball, use_native=False, device=CPU),
                          [(rot_z(ANGLE), CENTER, 1.0)], mats=np.int32([2]), device=CPU)
    ic = make_instanced_clusters(inst, base, device=CPU)
    # the instanced scene keeps the spheres; its mesh lives in the instances
    iscene = build_pt_scene(device=CPU, **{k: v for k, v in args.items()
                                           if k not in ("triangles", "tri_mats", "tri_uvs")})
    return cs, ic, iscene


def test_scene_tables_and_atlas_match_jax():
    """Normal maps and albedo images share one atlas; every table equals
    JAX's, with and without mip chains; JAX's fields carry across."""
    for tex_mips in (False, True):
        args = scene_args(tex_mips)
        js = jax_build_pt_scene(**args)
        scene = build_pt_scene(device=CPU, **args)
        want = jax_arrays(js)
        assert_same_scene(scene, want)
        assert scene.has_normal_map and scene.needs_tan and scene.needs_uv
        assert scene.has_mips == tex_mips and scene.n_mip_levels == js.n_mip_levels
        assert (scene.num_sphere_slots, scene.num_triangle_slots) == (4, 80)
        carried = pt_scene_from_numpy(want, device=CPU)
        assert_same_scene(carried, want)
        assert carried.needs_tan and carried.has_mips == tex_mips
    rect = scene.mat_nrm_rect.numpy()
    assert (rect[:, 2] > 0).tolist() == [False, True, True, False, True]
    np.testing.assert_array_equal(scene.mat_nrm_scale.numpy(), np.float32([0, 1, 1, 0, 2]))


def test_perturb_normal_matches_jax():
    """_perturb_normal on (64, 64) planes: seeded unit normals (some within
    the fallback's |n.z| >= 0.9 cap), raw tangents (some zero or parallel to
    n: the fallback axis), UVs and materials (one unmapped), nearest and
    bilinear; the decoded flat texel (0.5, 0.5, 0.5) keeps n."""
    rng = np.random.default_rng(11)
    args = scene_args()
    args["materials"][0]["normal"] = np.full((2, 2, 3), 0.5, np.float32)  # decodes to 0
    js = jax_build_pt_scene(**args)
    scene = build_pt_scene(device=CPU, **args)
    shape = (64, 64)
    n = rng.normal(size=(3,) + shape)
    n[2, :8] = 50.0  # near +z: the x x n fallback
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    tan = rng.normal(0.0, 2.0, (3,) + shape).astype(np.float32)
    tan[:, 8:12] = 0.0  # degenerate
    tan[:, 12:16] = n[:, 12:16] * 3.0  # parallel to n
    uv = rng.uniform(-1.0, 2.0, (2,) + shape).astype(np.float32)
    mat = rng.integers(0, 5, shape).astype(np.int32)
    for bilinear in (False, True):
        want = jwave._perturb_normal(js, jnp.asarray(mat), tuple(jnp.asarray(x) for x in n),
                                     tuple(jnp.asarray(x) for x in tan),
                                     tuple(jnp.asarray(x) for x in uv), bilinear=bilinear)
        got = wavefront._perturb_normal(scene, torch.from_numpy(mat),
                                        tuple(torch.from_numpy(x) for x in n),
                                        tuple(torch.from_numpy(x) for x in tan),
                                        tuple(torch.from_numpy(x) for x in uv), bilinear=bilinear)
        got, want = np.stack([g.numpy() for g in got]), np.stack([np.asarray(w) for w in want])
        np.testing.assert_allclose(got, want, **FN_TOL)
        keep = np.isin(mat, (0, 3))
        np.testing.assert_array_equal(got[:, keep], n[:, keep])  # unmapped, or the flat texel
        moved = np.abs(got - n).max(0)[~keep]
        assert (moved > 1e-3).mean() > 0.9


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_rebin_route_is_the_megakernel(filt):
    """The normal-mapped scene with the icosphere as a ClusterSet and as a
    rotated instance: the rebin route (K5's plain version) bit for bit the
    megakernel (K4's), render_pt_fast within tests/test_megakernel.py:37-40's
    bounds of it, and the maps move the image (the same scene without them
    differs). JAX's render of such a scene, normal maps on spheres and on
    the mesh, as a ClusterSet and as an instance:
    tests/test_torch_mips.py::test_trilinear_renders_match_jax."""
    args = scene_args()
    cfg = PTConfig(**SIZE, rng="pcg", tex_filter=filt)
    scene = build_pt_scene(device=CPU, **args)
    cs, ic, iscene = port_meshes(args, scene)
    kw = dict(seed=seed_from_int(13))
    megas = []
    for sc, mesh in ((scene, cs), (iscene, ic)):
        mega = pt.render_pt_mega(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        megas.append(mega[0])
        rb = pt.render_pt_rebin(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        assert torch.equal(rb[0], mega[0]) and int(rb[1]) == int(mega[1])
        fast = wavefront.render_pt_fast(cfg, sc, *cam(), 2, bvh=mesh, **kw)
        hold_megakernel_bounds(fast[0].numpy(), fast[1], mega[0].numpy(), mega[1])
        assert pt.uses_tex_instantiation(sc, mesh)
    flat = dict(args, materials=[{k: v for k, v in m.items() if k != "normal"}
                                 for m in args["materials"]])
    plain = pt.render_pt_mega(cfg, build_pt_scene(device=CPU, **flat), *cam(), 2, bvh=cs, **kw)
    assert (plain[0] - megas[0]).abs().max() > 1e-2


def test_aov_normal_guide_is_the_shading_normal():
    """render_aovs' normal (2 spp, bilinear) against JAX's, with the
    icosphere as a ClusterSet on the port's side and the stacked mesh on
    JAX's: hit flags equal and the planes within atol / rtol 1e-4 but for
    at most 1e-3 of the pixels (rounded up to a whole pixel)."""
    args = scene_args()
    cfg = JPTConfig(**SIZE, tex_filter="bilinear")
    want = jax_aov.render_aovs(cfg, jax_build_pt_scene(**args), jnp.asarray(POS),
                               jnp.asarray(QUAT), 2, jax.random.PRNGKey(5))
    want = {k: np.asarray(v) for k, v in want.items()}
    scene = build_pt_scene(device=CPU, **args)
    cs, _, _ = port_meshes(args, scene)
    got = render_aovs(PTConfig(**SIZE, tex_filter="bilinear"), scene, *cam(), 2, 5, bvh=cs)
    bad = (got["depth"].numpy() > 0) != (want["depth"] > 0)
    for k in ("albedo", "normal", "depth"):
        off = ~np.isclose(got[k].numpy(), want[k], **AOV_TOL)
        bad |= off.any(-1) if off.ndim == 3 else off
    assert bad.sum() <= math.ceil(1e-3 * bad.size), np.argwhere(bad).tolist()
    flat = dict(args, materials=[{k: v for k, v in m.items() if k != "normal"}
                                 for m in args["materials"]])
    geo = render_aovs(PTConfig(**SIZE, tex_filter="bilinear"),
                      build_pt_scene(device=CPU, **flat), *cam(), 2, 5, bvh=cs)
    moved = np.abs(geo["normal"].numpy() - got["normal"].numpy()).max(-1)
    assert (moved > 1e-2).mean() > 0.03


def test_json_normal_key_loads_to_jax_arrays(tmp_path):
    """A material's "normal" as {"npy": path, "scale"}, beside an image:
    load_scene_json equals JAX's bundle."""
    tex, nrm, _ = maps(7)
    np.save(str(tmp_path / "tex.npy"), tex)
    np.save(str(tmp_path / "nrm.npy"), nrm)
    spec = {"materials": [{"albedo": [0.6, 0.6, 0.6], "image": {"npy": "tex.npy", "scale": 2},
                           "normal": {"npy": "nrm.npy", "scale": 3}},
                          {"albedo": [0.8, 0.2, 0.2], "normal": {"npy": "nrm.npy"}},
                          {"albedo": [0, 0, 0], "emission": [9, 9, 9]}],
            "spheres": [{"center": [-1.5, 6, 0], "radius": 1, "mat": 1},
                        {"center": [1.5, 6, 0], "radius": 1, "mat": 0},
                        {"center": [3, 4, 3], "radius": 0.5, "mat": 2}]}
    path = str(tmp_path / "nrm.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    got, want = load_scene_json(path, device="cpu"), jax_load(path)
    assert_same_scene(got.scene, jax_arrays(want.scene))
    assert got.scene.has_normal_map and got.scene.needs_tan and not got.scene.has_mips
