"""The port's light features on the CPU against the JAX package, inputs made
from seeds: fog and single-scatter media (PTConfig.fog_density,
fog_scatter, fog_color), the two-level light tree (build_pt_scene
light_tree=C, light_sampling="tree") and mesh lights per pass and per lane
(build_pt_scene mesh_lights=True | "lane").

- The tables bit for bit JAX's: every PTScene field of a tree, a per-pass
  and a lane mesh-light scene (build_pt_scene and pt_scene_from_numpy of
  JAX's arrays), scene.mesh_light_rows at passes 0..15 under three seeds,
  integrator.tree_cluster_weights and wavefront._tree_cluster_weights at
  seeded points.
- render_pt_fast against JAX's render_pt_fast (its jnp route, one compile a
  case; the JAX megakernel equals that route on these features:
  tests/test_light_tree.py:233-246, tests/test_mesh_lights.py:95-128,
  tests/test_media.py:138-152), 32x16, 2 bounces, 2 spp, within JAX's own
  cross-engine bound assert_allclose(rtol=2e-5, atol=2e-6)
  (tests/test_mesh_lights.py:128-129), the ray counts equal: fog with
  single scattering under pcg and threefry; tree sampling on
  tests/test_light_tree.py's grid (n = 4, C = 4); mesh lights per pass and
  per lane over a ClusterSet (the port's gather path against JAX's jnp
  intersector over the same triangles), the lane case also in fog under
  threefry with uniform selection (the lane dimension before the media's).
- The plain K4 and K5 (render_pt_mega and render_pt_rebin on CPU tensors)
  bit for bit the plain wavefront (1 / 2 is exact, so K4's acc * (1 / spp)
  is render_pt_fast's acc / spp), and K5 == K4, on fog + the tree and on
  fog + mesh lights per pass and per lane over a ClusterSet; progressive_render
  in two chunks, on its default route and through the megakernel, the
  2-pass render within float summation (rtol 1e-6 / atol 1e-6,
  tests/test_mesh_lights.py's chunk invariance); trace_pass_soa takes the
  pass's mesh-light row as a tensor or as 14 scalars.
- Each of JAX's ValueErrors for these inputs raises in the port with the
  same type and message: build_pt_scene's refusals, the fog_scatter
  bound, the tree without tables, the tree with triangle slot lights over
  the kernels' intersectors.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels need the card:
chip_smoke.py phase 24 holds them to these plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel.mesh import icosphere as jax_icosphere
from raytracing_engine_tpu.pathtracer import integrator as jintegrator
from raytracing_engine_tpu.pathtracer import scene as jscene
from raytracing_engine_tpu.pathtracer import wavefront as jwavefront
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig

from raytracing_engine_tpu_torch.accel import build_clusters
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.cuda.cluster import FrameClusters
from raytracing_engine_tpu_torch.pathtracer import PTConfig, build_pt_scene, integrator
from raytracing_engine_tpu_torch.pathtracer import pt_scene_from_numpy, wavefront
from raytracing_engine_tpu_torch.pathtracer.scene import mesh_light_rows
from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUAT = (0.0, 0.0, 0.0, 1.0)
JAX_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_mesh_lights.py:128-129
SIZE = dict(width=32, height=16, max_bounces=2)
SPP, KEY = 2, 7
FOG = dict(fog_density=0.15, fog_scatter=0.12, fog_color=(0.1, 0.2, 0.3))
# tests/test_media.py:138-146: an emissive sphere over a diffuse ground
MEDIA = dict(spheres=[((0.0, 6.0, 0.0), 2.0, 0), ((0.0, 6.0, -51.5), 50.0, 1)],
             materials=[{"albedo": (0, 0, 0), "emission": (5.0,) * 3},
                        {"albedo": (0.6, 0.6, 0.6)}])
TREE_POS = (0.0, 0.0, 1.0)
MESH_POS = (0.0, -1.0, 0.5)


def grid_light_scene(n=4, light_tree=4):
    """tests/test_light_tree.py:29-47's build_pt_scene arguments."""
    mats = [{"albedo": (0.6, 0.6, 0.6)}] + [
        {"albedo": (0, 0, 0), "emission": (40.0, 32.0, 24.0)} for _ in range(n * n)]
    spheres = [((0.0, 30.0, -1001.0), 1000.0, 0)]
    for i in range(n):
        for j in range(n):
            spheres.append(((i * 16.0 - 24.0, 14.0 + j * 16.0, 2.0), 0.4, 1 + i * n + j))
    return dict(spheres=spheres, materials=mats, light_tree=light_tree)


def mesh_scene(mesh_lights, subdivisions=1):
    """tests/test_mesh_lights.py:26-46's build_pt_scene arguments: an
    emissive icosphere (80 triangles at subdivisions 1) above a two-triangle
    floor, and a diffuse ball."""
    lamp = np.asarray(jax_icosphere(subdivisions=subdivisions, radius=1.0,
                                    center=(0.0, 6.0, 2.5)), np.float32)
    floor = np.array([[[-8, -2, -1.5], [8, -2, -1.5], [8, 14, -1.5]],
                      [[-8, -2, -1.5], [8, 14, -1.5], [-8, 14, -1.5]]], np.float32)
    return dict(spheres=[((1.2, 6.0, -0.6), 0.9, 2)],
                triangles=np.concatenate([floor, lamp]),
                tri_mats=np.array([0] * 2 + [1] * len(lamp), np.int32),
                materials=[{"albedo": (0.65, 0.6, 0.55)},
                           {"albedo": (0, 0, 0), "emission": (6.0,) * 3},
                           {"albedo": (0.4, 0.45, 0.7)}],
                mesh_lights=mesh_lights)


def jax_fields(js):
    """The JAX PTScene's non-None array fields as numpy arrays."""
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
            if getattr(js, f.name) is not None
            and not isinstance(getattr(js, f.name), (bool, int))}


def assert_scene_equal(got, js):
    """Every field of the port's PTScene equal to the JAX one's, bit for bit
    (a None where JAX has None, the static flags alike)."""
    for f in dataclasses.fields(js):
        want = getattr(js, f.name)
        have = getattr(got, f.name)
        if want is None or isinstance(want, (bool, int)):
            assert have == want, f.name
        else:
            np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=f.name)
    for prop in ("has_mesh_light", "has_lane_mesh_light", "has_light_tree"):
        assert getattr(got, prop) == getattr(js, prop), prop


def jax_render(cfg_kw, scene_kw, pos):
    img, n = jwavefront.render_pt_fast(JPTConfig(**cfg_kw), jscene.build_pt_scene(**scene_kw),
                                       jnp.asarray(pos, jnp.float32), jnp.asarray(QUAT), SPP,
                                       jax.random.PRNGKey(KEY))
    return np.asarray(img), int(n)


def port_render(cfg_kw, scene_kw, pos, clusters=False):
    scene = build_pt_scene(device=CPU, **scene_kw)
    bvh = None
    if clusters:
        bvh = build_clusters(scene_kw["triangles"], tri_mats=scene_kw["tri_mats"], device=CPU)
    img, n = wavefront.render_pt_fast(PTConfig(**cfg_kw), scene, torch.tensor(pos),
                                      torch.tensor(QUAT), SPP, key=KEY, bvh=bvh)
    assert img.shape == (SIZE["height"], SIZE["width"], 3) and torch.isfinite(img).all()
    assert img.mean() > 0
    return img.numpy(), int(n)


def hold_jax(cfg_kw, scene_kw, pos, clusters=False):
    got, n = port_render(cfg_kw, scene_kw, pos, clusters)
    want, n_want = jax_render(cfg_kw, scene_kw, pos)
    np.testing.assert_allclose(got, want, **JAX_TOL)
    assert n == n_want


def test_light_tables_match_jax():
    kws = {"tree": grid_light_scene(), "pass": mesh_scene(True), "lane": mesh_scene("lane")}
    jscenes = {}
    for name, kw in kws.items():
        js = jscene.build_pt_scene(**kw)
        assert_scene_equal(build_pt_scene(device=CPU, **kw), js)
        assert_scene_equal(pt_scene_from_numpy(jax_fields(js), device=CPU), js)
        jscenes[name] = js
    assert jscenes["tree"].has_light_tree and jscenes["pass"].has_mesh_light
    assert jscenes["lane"].has_lane_mesh_light
    # the per-pass rows: one pcg4d draw a pass, the area CDF's bin (side left)
    js = jscenes["pass"]
    ps = build_pt_scene(device=CPU, **kws["pass"])
    for seed in (0, -1640531527, 123457):
        want = np.asarray(jscene.mesh_light_rows(js, seed, jnp.arange(16, dtype=jnp.int32)))
        got = mesh_light_rows(ps, seed, list(range(16)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(np.unique(want[:, 0])) > 1  # the passes pick different triangles
        np.testing.assert_array_equal(mesh_light_rows(ps, seed, 9).numpy(), want[9:10])
    # the tree's weights at seeded points, both forms
    tree = build_pt_scene(device=CPU, **kws["tree"])
    p3 = np.random.default_rng(5).uniform(-30.0, 70.0, (6, 5, 3)).astype(np.float32)
    w_want, t_want = jintegrator.tree_cluster_weights(jscenes["tree"], jnp.asarray(p3))
    w_got, t_got = integrator.tree_cluster_weights(tree, torch.from_numpy(p3))
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))
    np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_want))
    planes = tuple(p3[..., a] for a in range(3))
    ws_want, tot_want = jwavefront._tree_cluster_weights(
        jscenes["tree"], tuple(jnp.asarray(x) for x in planes))
    ws_got, tot_got = wavefront._tree_cluster_weights(
        tree, tuple(torch.from_numpy(x) for x in planes))
    for g, w in zip(ws_got, ws_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tot_got.numpy(), np.asarray(tot_want))


def test_fog_and_media_match_jax():
    """Fog with single scattering, pcg and threefry (the threefry planes come
    through kernel K9's plain version: JAX's nu, 9 here, on every bounce)."""
    for rng in ("pcg", "threefry"):
        hold_jax(dict(SIZE, rng=rng, **FOG), MEDIA, (0.0, 0.0, 0.0))


def test_light_tree_matches_jax():
    hold_jax(dict(SIZE, rng="pcg", light_sampling="tree"), grid_light_scene(), TREE_POS)


def test_mesh_lights_per_pass_match_jax():
    hold_jax(dict(SIZE, rng="pcg"), mesh_scene(True), MESH_POS, clusters=True)


def test_lane_mesh_lights_match_jax():
    hold_jax(dict(SIZE, rng="pcg"), mesh_scene("lane"), MESH_POS, clusters=True)
    hold_jax(dict(SIZE, rng="threefry", fog_density=0.05, fog_scatter=0.04,
                  light_sampling="uniform"), mesh_scene("lane"), MESH_POS, clusters=True)


def test_plain_k4_k5_equal_the_wavefront():
    pos, quat = torch.tensor(TREE_POS), torch.tensor(QUAT)
    cfg = PTConfig(**SIZE, rng="pcg", light_sampling="tree", fog_density=0.02, fog_scatter=0.01)
    scene = build_pt_scene(device=CPU, **grid_light_scene())
    want, n_want = wavefront.render_pt_fast(cfg, scene, pos, quat, SPP, key=KEY)
    got, n = pt.render_pt_mega(cfg, scene, pos, quat, SPP, key=KEY)
    assert torch.equal(got, want) and int(n) == int(n_want)
    pos = torch.tensor(MESH_POS)
    for mode in (True, "lane"):
        kw = mesh_scene(mode)
        scene = build_pt_scene(device=CPU, **kw)
        cs = build_clusters(kw["triangles"], tri_mats=kw["tri_mats"], device=CPU)
        cfg = PTConfig(**SIZE, rng="pcg", **FOG)
        want, n_want = wavefront.render_pt_fast(cfg, scene, pos, quat, SPP, key=KEY, bvh=cs)
        k4, n4 = pt.render_pt_mega(cfg, scene, pos, quat, SPP, key=KEY, bvh=cs)
        k5, n5 = pt.render_pt_rebin(cfg, scene, pos, quat, SPP, key=KEY, bvh=cs)
        assert torch.equal(k4, want) and int(n4) == int(n_want), mode
        assert torch.equal(k5, k4) and int(n5) == int(n4), mode
        assert (k4.amax(-1) > 0).double().mean() > 0.5
    # progressive_render passes the features through, on its default route
    # and with the megakernel: two chunks of one pass each, the 2-pass render
    # within the float summation of the accumulator
    for fn in (None, pt.render_pt_mega):
        st = ProgressiveState.start(cfg, pos, quat, key=KEY, device=CPU)
        for st in progressive_render(cfg, scene, st, 2, passes_per_chunk=1, bvh=cs, render_fn=fn):
            pass
        np.testing.assert_allclose((st.accum / 2).numpy(), k4.numpy(), rtol=1e-6, atol=1e-6)
    # trace_pass_soa takes the pass's row: pass 3 of a per-pass render
    scene = build_pt_scene(device=CPU, **mesh_scene(True))
    row = mesh_light_rows(scene, 11, 3)[0]
    a, na = wavefront.trace_pass_soa(cfg, scene, pos, quat, bvh=cs, seed0=11, mesh_light=row)
    b, nb = wavefront.trace_pass_soa(cfg, scene, pos, quat, bvh=cs, seed0=11,
                                     mesh_light=tuple(float(x) for x in row))
    assert torch.equal(a, b) and int(na) == int(nb) and a.mean() > 0


def both_raise(jax_call, port_call):
    """jax_call() and port_call() raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_value_errors_match_jax():
    tris = mesh_scene(True)
    no_light = dict(tris, materials=[{"albedo": (0.5,) * 3}] * 3)
    flat = dict(tris, triangles=np.zeros_like(tris["triangles"]))
    cases = {
        "mode": dict(tris, mesh_lights="many"),
        "no emissive triangle": no_light,
        "zero area": flat,
        "tree with mesh lights": dict(tris, light_tree=2),
        "tree without lights": dict(no_light, mesh_lights=False, light_tree=2),
        "emissive slot >= TRI_UNROLL_MAX": dict(tris, mesh_lights=False),
        "tree over slot 32": dict(tris, mesh_lights=False, allow_many_tri_lights=True,
                                  light_tree=2),
    }
    lots = mesh_scene("lane", subdivisions=4)  # 5,120 emissive triangles > 4,096
    cases["lane over 4096"] = lots
    for name, kw in cases.items():
        both_raise(lambda: jscene.build_pt_scene(**kw),
                   lambda: build_pt_scene(device=CPU, **kw))
    # the renderers' checks
    js, ps = jscene.build_pt_scene(**MEDIA), build_pt_scene(device=CPU, **MEDIA)
    quat = torch.tensor(QUAT)
    for bad in (dict(fog_density=0.1, fog_scatter=0.2), dict(light_sampling="tree")):
        cfg = dict(SIZE, rng="pcg", **bad)
        both_raise(lambda: jwavefront.render_pt_fast(JPTConfig(**cfg), js, jnp.zeros(3),
                                                     jnp.asarray(QUAT), 1),
                   lambda: wavefront.render_pt_fast(PTConfig(**cfg), ps, torch.zeros(3), quat, 1))
        with pytest.raises(ValueError):
            pt.render_pt_mega(PTConfig(**cfg), ps, torch.zeros(3), quat, 1)
    # the tree with triangle slot lights over the kernels' intersectors
    kw = dict(mesh_scene(False, subdivisions=0), light_tree=2)
    scene = build_pt_scene(device=CPU, **kw)
    assert scene.n_tri_slot_lights == 20
    cs = build_clusters(kw["triangles"], tri_mats=kw["tri_mats"], device=CPU)
    cfg = PTConfig(**SIZE, rng="pcg", light_sampling="tree")
    for call in (lambda: pt.render_pt_mega(cfg, scene, torch.zeros(3), quat, 1, bvh=cs),
                 lambda: pt.render_pt_rebin(cfg, scene, torch.zeros(3), quat, 1, bvh=cs),
                 lambda: wavefront.trace_pass_soa(cfg, scene, torch.zeros(3), quat, seed0=1,
                                                  bvh=FrameClusters.at(cs, torch.zeros(3)))):
        with pytest.raises(ValueError, match="triangle slot lights"):
            call()
    # the gather path recovers a hit triangle's slot: it renders the tree
    img, _ = wavefront.render_pt_fast(cfg, scene, torch.zeros(3), quat, 1, key=KEY, bvh=cs)
    assert torch.isfinite(img).all()
