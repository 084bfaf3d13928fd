"""The port's UV textures (UV-space checkers, atlas image textures, nearest
and bilinear; pathtracer/scene.py pack_texture_atlas, pathtracer/wavefront.py
_sample_rect and the hit UVs, ops/cuda/cluster.py's UV planes) against the
JAX package on the CPU, inputs made from numpy seeds.

- pack_texture_atlas bit for bit with JAX's, its refusals with JAX's
  messages;
- _atlas_fetch, _rect_texel and _sample_rect (nearest and bilinear) on
  seeded UVs within rtol 1e-6 / atol 1e-7;
- K6's plain sweep on a UV table (ROWS_UV): every plane, the UV pair and
  the texture-u tangent (tan=True) included, against JAX's cluster_intersect
  (one interpret-mode compile, an 80-triangle icosphere);
  build_clusters(vertex_uvs=), save_obj(uvs=) and load_obj(uvs=True) equal
  JAX's;
- renders at 32x16, 3 bounces, 2 spp, pcg, nearest and bilinear: a floor
  with a world checker, a UV-checkered sphere, an image-textured sphere and
  two unrolled slots with tri_uvs (render_pt_fast and render_pt_mega), and
  the same scene with an image-textured UV icosphere as a ClusterSet
  (render_pt_fast's gather path, render_pt_mega's attributes path, and the
  rebin route bit for bit with the megakernel), against JAX's
  render_pt_fast (the jnp paths: unrolled slots, and the stacked mesh
  intersector with tri_uv) within tests/test_megakernel.py:37-40's bounds;
- render_aovs' albedo plane against JAX's;
- a JSON scene with a PNG written by utils/image.write_png and an OBJ with
  vt written by save_obj(uvs=): load_scene_json equals JAX's.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels' branches need the card:
chip_smoke.py phase 20 holds them to these plain versions.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import clusters as jclusters
from raytracing_engine_tpu.accel import icosphere as jax_icosphere
from raytracing_engine_tpu.accel import mesh as jmesh
from raytracing_engine_tpu.ops.pallas.cluster_intersect import cluster_intersect as jax_ci
from raytracing_engine_tpu.pathtracer import aov as jax_aov
from raytracing_engine_tpu.pathtracer import scene as jscene_mod
from raytracing_engine_tpu.pathtracer import wavefront as jwave
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json as jax_load
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import build_clusters, clusters, mesh
from raytracing_engine_tpu_torch.ops.cuda import cluster, pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import (
    PTConfig,
    build_pt_scene,
    load_scene_json,
    render_aovs,
    wavefront,
)
from raytracing_engine_tpu_torch.pathtracer import scene as scene_mod
from raytracing_engine_tpu_torch.pathtracer.scene import OPTIONAL_FIELDS, TENSOR_FIELDS
from raytracing_engine_tpu_torch.utils.image import write_png

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=3)
POS = (0.0, -1.5, 1.8)
QUAT = (-0.109778, 0.0, 0.0, 0.993956)  # examples/showcase.json's camera
FN_TOL = dict(rtol=1e-6, atol=1e-7)
# XLA contracts the intersection arithmetic into FMAs on the CPU (ROADMAP.md
# hazard 1): AOV hit points move by up to 3e-5 against the port's, and the
# textures' lerps carry that into the albedo
AOV_TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = TENSOR_FIELDS + OPTIONAL_FIELDS
BALL = dict(subdivisions=1, radius=0.9, center=(2.6, 9.0, 1.5))


def textures(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (6, 10, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (5, 7, 3)).astype(np.float32))


def spherical_uvs(tris, center):
    """Per-corner spherical-projection UVs of a mesh around center."""
    p = tris - np.asarray(center, np.float32)
    u = np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5
    v = np.arccos(np.clip(p[..., 2] / np.linalg.norm(p, axis=-1), -1.0, 1.0)) / np.pi
    return np.stack([u, v], -1).astype(np.float32)


def scene_args(with_mesh: bool):
    """The textures scene (both packages): world-checkered floor (material
    0), UV-checkered sphere (1), image sphere (2, tiled twice), a quad of
    two unrolled slots with tri_uvs and an image (3), a sphere light (4);
    with_mesh adds an image-textured icosphere (material 2) with spherical
    UVs after the quad, 82 triangle slots in all."""
    tex, tex2 = textures()
    mats = [{"albedo": (0.7, 0.7, 0.65), "checker": {"color": (0.2, 0.3, 0.4), "scale": 1.0}},
            {"albedo": (0.8, 0.2, 0.2),
             "checker": {"color": (0.1, 0.6, 0.2), "scale": 8.0, "space": "uv"}},
            {"image": {"pixels": tex, "scale": 2.0}},
            {"image": tex2},
            {"albedo": (0.0, 0.0, 0.0), "emission": (20.0, 18.0, 15.0)}]
    spheres = [((0.0, 8.0, -1001.0), 1000.0, 0), ((-1.5, 6.0, 0.0), 1.0, 1),
               ((1.5, 7.0, 0.0), 1.0, 2), ((3.0, 4.0, 3.0), 0.5, 4)]
    tris = np.array([[[-1, 9, -1], [1, 9, -1], [1, 9, 1]],
                     [[-1, 9, -1], [1, 9, 1], [-1, 9, 1]]], np.float32)
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
    tmats = [3, 3]
    if with_mesh:
        ball = jax_icosphere(**BALL).astype(np.float32)
        tris = np.concatenate([tris, ball])
        uvs = np.concatenate([uvs, spherical_uvs(ball, BALL["center"])])
        tmats = tmats + [2] * len(ball)
    return dict(spheres=spheres, materials=mats, triangles=tris,
                tri_mats=np.asarray(tmats, np.int32), tri_uvs=uvs)


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


def test_texture_atlas_matches_jax():
    """Seeded images over several shelves; the width and row budgets refuse
    as JAX's do."""
    rng = np.random.default_rng(2)
    sizes = [(6, 10), (5, 7), (3, 120), (9, 64), (2, 64), (4, 1), (7, 33)]
    imgs = [rng.uniform(0.0, 2.0, (h, w, 3)).astype(np.float32) for h, w in sizes]
    for n in (1, 3, len(imgs)):
        got, want = scene_mod.pack_texture_atlas(imgs[:n]), jscene_mod.pack_texture_atlas(imgs[:n])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert scene_mod.ATLAS_W == 128 and scene_mod.ATLAS_MAX_ROWS == 32
    for bad in ([np.zeros((2, 129, 3))], [np.zeros((33, 2, 3))], [np.zeros((2, 2))]):
        with pytest.raises(ValueError) as got:
            scene_mod.pack_texture_atlas(bad)
        with pytest.raises(ValueError) as want:
            jscene_mod.pack_texture_atlas(bad)
        assert str(got.value) == str(want.value)


def test_sample_rect_matches_jax():
    """_atlas_fetch, _rect_texel and _sample_rect, nearest and bilinear, on
    (64, 64) planes of seeded UVs (wrapping, negative) and rects of a packed
    atlas (and an empty rect, w = 0)."""
    rng = np.random.default_rng(9)
    atlas, rects = jscene_mod.pack_texture_atlas(list(textures()) + [np.ones((3, 90, 3))])
    rects = np.concatenate([rects, np.zeros((1, 4), np.float32)])
    pick = rng.integers(0, len(rects), (64, 64))
    r = rects[pick]
    uv = tuple(rng.uniform(-2.0, 3.0, (64, 64)).astype(np.float32) for _ in range(2))
    s = rng.choice(np.float32([0.5, 1.0, 3.0]), (64, 64))
    ty = rng.integers(-1, atlas.shape[0] // 3 + 1, (64, 64))
    tx = rng.integers(0, 128, (64, 64))

    def run(mod, cast, cast_i):
        rect = tuple(cast(np.ascontiguousarray(r[..., k])) for k in range(4))
        uvc, sc = tuple(cast(u) for u in uv), cast(s)
        a = cast(atlas)
        out = {"atlas_fetch": mod._atlas_fetch(a, cast_i(ty), cast_i(tx)),
               "rect_texel": mod._rect_texel(*rect, uvc, sc),
               "nearest": mod._sample_rect(a, *rect, uvc, sc),
               "bilinear": mod._sample_rect(a, *rect, uvc, sc, bilinear=True)}
        return {k: np.stack([np.asarray(x, np.float32) for x in v]) for k, v in out.items()}

    want = run(jwave, jnp.asarray, lambda a: jnp.asarray(a, jnp.int32))
    got = run(wavefront, torch.from_numpy, torch.from_numpy)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **FN_TOL)
    assert not np.array_equal(want["nearest"], want["bilinear"])


@pytest.fixture(scope="module")
def uv_sets():
    """An 80-triangle icosphere with spherical UVs as a UV ClusterSet in both
    packages, and JAX's closest-hit sweep of a 16 x 16 grid of camera rays
    with attributes and tangents (one interpret-mode compile)."""
    ball = jax_icosphere(**BALL).astype(np.float32)
    uvs = spherical_uvs(ball, BALL["center"])
    mats = (np.arange(len(ball)) % 3).astype(np.int32)
    jcs = jclusters.build_clusters(ball, tri_mats=mats, vertex_uvs=uvs)
    cs = build_clusters(ball, tri_mats=mats, vertex_uvs=uvs, device=CPU)
    cfg = PTConfig(width=16, height=16)
    u = torch.full((16, 16), 0.5)
    o, d = wavefront._camera_rays(cfg, torch.tensor([2.6, 7.6, 1.5]),
                                  torch.tensor([0.0, 0.0, 0.0, 1.0]), u, u)
    o, d = tuple(x.contiguous().numpy() for x in o), tuple(x.contiguous().numpy() for x in d)
    want = jax_ci(jcs, tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d),
                  jnp.inf, attrs=True, tan=True, interpret=True)
    return dict(ball=ball, uvs=uvs, mats=mats, jcs=jcs, cs=cs, o=o, d=d,
                want=[np.asarray(x) for x in want])


def test_uv_table_and_k6_uv_planes_match_jax(uv_sets, tmp_path):
    """build_clusters(vertex_uvs=) equals JAX's table; K6's plain sweep
    returns JAX's twelve planes (t, slot, normal, material, area, u, v,
    and with tan=True the texture-u tangent), each within atol 1e-6 on the
    hits; the OBJ round trip with UVs equals JAX's."""
    jcs, cs = uv_sets["jcs"], uv_sets["cs"]
    assert cs.has_uv and cs.smooth and cs.tri.shape[0] == clusters.ROWS_UV
    for name in ("tri", "boxes", "super_boxes", "perm"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(), np.asarray(getattr(jcs, name)),
                                      err_msg=name)
    tb = cluster.sweep_tables(cs)
    assert torch.equal(tb.tuv[:, :6], cs.tri[32:38].T) and torch.all(tb.tuv[:, 6:] == 0)
    got = [x.numpy() for x in cluster.cluster_intersect(
        cs, tuple(torch.from_numpy(x) for x in uv_sets["o"]),
        tuple(torch.from_numpy(x) for x in uv_sets["d"]), float("inf"), attrs=True, tan=True)]
    want = uv_sets["want"]
    assert len(got) == len(want) == 12
    np.testing.assert_array_equal(got[1], want[1])
    hit = want[1] >= 0
    assert hit.sum() > 40, "too few hits to mean anything"
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6, atol=0.0)
    for a in range(2, 12):  # nx, ny, nz, mat, area, u, v, tx, ty, tz
        np.testing.assert_allclose(got[a][hit], want[a][hit], atol=1e-6, rtol=0.0)
        assert np.all(got[a][~hit] == 0.0)
    assert np.ptp(got[7][hit]) > 0.1 and np.ptp(got[8][hit]) > 0.1
    assert np.abs(got[9:12]).max() > 0.1
    # the OBJ round trip: save_obj(uvs=) writes JAX's bytes, load_obj reads JAX's arrays
    mesh.save_obj(str(tmp_path / "port.obj"), uv_sets["ball"], uvs=uv_sets["uvs"])
    jmesh.save_obj(str(tmp_path / "jax.obj"), uv_sets["ball"], uvs=uv_sets["uvs"])
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    for g, w in zip(mesh.load_obj(str(tmp_path / "port.obj"), uvs=True),
                    jmesh.load_obj(str(tmp_path / "port.obj"), uvs=True)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_renders_match_jax(filt):
    """The textures scene through the unrolled slots, and with the UV
    icosphere as a ClusterSet, against JAX's jnp render_pt_fast."""
    cfg = PTConfig(**SIZE, rng="pcg", tex_filter=filt)
    jcfg = JPTConfig(**SIZE, rng="pcg", tex_filter=filt)
    for with_mesh in (False, True):
        args = scene_args(with_mesh)
        js = jax_build_pt_scene(**args)
        scene = build_pt_scene(device=CPU, **args)
        assert_same_scene(scene, jax_arrays(js))
        assert scene.needs_uv and scene.has_image and scene.has_tri_uv
        want, n_want = jax_render_pt_fast(jcfg, js, jnp.asarray(POS), jnp.asarray(QUAT), 2,
                                          jax.random.PRNGKey(13))
        want, n_want = np.asarray(want), float(n_want)
        cs = None
        if with_mesh:
            cs = build_clusters(args["triangles"], tri_mats=args["tri_mats"],
                                vertex_uvs=args["tri_uvs"], device=CPU)
        fast = wavefront.render_pt_fast(cfg, scene, *cam(), 2, seed=seed_from_int(13), bvh=cs)
        mega = pt.render_pt_mega(cfg, scene, *cam(), 2, seed=seed_from_int(13), bvh=cs)
        for got, n in (fast, mega):
            assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
            hold_megakernel_bounds(got.numpy(), n, want, n_want)
        if with_mesh:
            rb = pt.render_pt_rebin(cfg, scene, *cam(), 2, seed=seed_from_int(13), bvh=cs)
            assert torch.equal(rb[0], mega[0]) and int(rb[1]) == int(mega[1])
        else:
            assert torch.equal(fast[0], mega[0])
        assert 0.05 < want.mean() < 5.0


def test_aov_albedo_follows_uv_textures():
    """render_aovs' albedo (2 spp, bilinear) against JAX's: hit flags equal
    and the planes within atol / rtol 1e-4 but for at most 1e-3 of the
    pixels (rounded up to a whole pixel); texels of both images and both
    colors of the UV checker are seen."""
    args = scene_args(False)
    cfg = JPTConfig(**SIZE, tex_filter="bilinear")
    want = jax_aov.render_aovs(cfg, jax_build_pt_scene(**args), jnp.asarray(POS),
                               jnp.asarray(QUAT), 2, jax.random.PRNGKey(5))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = render_aovs(PTConfig(**SIZE, tex_filter="bilinear"), build_pt_scene(device=CPU, **args),
                      *cam(), 2, 5)
    bad = (got["depth"].numpy() > 0) != (want["depth"] > 0)
    for k in ("albedo", "normal", "depth"):
        off = ~np.isclose(got[k].numpy(), want[k], **AOV_TOL)
        bad |= off.any(-1) if off.ndim == 3 else off
    assert bad.sum() <= math.ceil(1e-3 * bad.size), np.argwhere(bad).tolist()
    alb = want["albedo"].reshape(-1, 3)
    for color in ((0.8, 0.2, 0.2), (0.1, 0.6, 0.2)):
        assert (np.abs(alb - color).max(-1) < 1e-6).any(), color
    flat = {(0.7, 0.7, 0.65), (0.2, 0.3, 0.4), (0.8, 0.2, 0.2), (0.1, 0.6, 0.2), (0.0, 0.0, 0.0)}
    textured = [a for a in alb if min(np.abs(a - c).max() for c in flat) > 1e-3]
    assert len(textured) > 20


def test_json_png_image_and_obj_uvs_load_to_jax_arrays(tmp_path):
    """A PNG texture written by the port's write_png and an OBJ with vt
    written by save_obj(uvs=), loaded with "uvs": true, a UV checker and a
    bilinear-ready scene: the port's load_scene_json equals JAX's bundle."""
    tex, _ = textures(7)
    write_png(str(tmp_path / "tex.png"), tex)
    ball = jax_icosphere(**BALL).astype(np.float32)
    mesh.save_obj(str(tmp_path / "ball.obj"), ball, uvs=spherical_uvs(ball, BALL["center"]))
    spec = {"materials": [{"albedo": [0.6, 0.6, 0.6], "image": {"png": "tex.png", "scale": 2}},
                          {"albedo": [0.8, 0.2, 0.2],
                           "checker": {"color": [0.1, 0.6, 0.2], "scale": 8, "space": "uv"}},
                          {"albedo": [0, 0, 0], "emission": [9, 9, 9]}],
            "spheres": [{"center": [-1.5, 6, 0], "radius": 1, "mat": 1},
                        {"center": [3, 4, 3], "radius": 0.5, "mat": 2}],
            "meshes": [{"obj": "ball.obj", "uvs": True, "mat": 0}]}
    path = str(tmp_path / "tex.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    got, want = load_scene_json(path, device="cpu"), jax_load(path)
    assert_same_scene(got.scene, jax_arrays(want.scene))
    for name in ("tris", "tri_mats", "tri_normals", "tri_uvs"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.scene.has_image and got.scene.needs_uv and got.tri_uvs is not None
