"""The port's config-3 slice on the CPU: the rebin renderer (kernel K5's
plain version), the megakernel with a ClusterSet (K4's), and the wavefront's
ClusterSet paths.

- The plain render_pt_rebin (over a ClusterSet) against the JAX
  render_pt_fast over the same triangles without an acceleration structure
  (its jnp mesh intersector: the same closest hits without an
  interpret-mode cluster kernel compile) on tests/test_rebin.py's mesh scene (icosphere(2) + a sphere light + a
  ground sphere) at 32x16, 2 bounces, pcg, PRNGKey(3) <-> seed_from_int(3),
  held to the megakernel bounds of tests/test_megakernel.py:37-40 (< 1% of
  pixels off by more than 1e-3, mean difference < 1e-4, ray counts within
  max(8, 1e-3 n)).
- Inside the port, bit for bit: rebin == mega with clusters for every
  regroup mode and at 2 spp; a band equals the rows of the full render;
  the attributes path and the gather path agree (flat and smooth tables);
  rebin_keys put dead rays last; the packed state round-trips.
- render_pt_fast(bvh=cs) (the gather path) is within the megakernel bounds
  of render_pt_mega(bvh=cs); progressive_render(bvh=cs) is chunk-invariant
  within float summation.

The kernels themselves need the card: chip_smoke.py phases 10-12 hold them
to these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.pathtracer import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import bvh as pbvh
from raytracing_engine_tpu_torch.accel import clusters, icosphere, smooth_vertex_normals
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.cuda.cluster import FrameClusters
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene, wavefront
from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=2)
QUAT = (0.0, 0.0, 0.0, 1.0)
SEED = 3
MODES = ["none", "oct", "morton", "oct_morton", "tile_oct", "none,morton"]


def _mesh_scene_args():
    """tests/test_rebin.py:34-56 without the extra materials."""
    tris = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    mats = [
        {"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
        {"albedo": (0, 0, 0), "emission": (8.0,) * 3, "kind": DIFFUSE},
        {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
    ]
    spheres = [((3.0, 3.0, 3.0), 1.0, 1), ((0.0, 5.0, -52.0), 50.0, 2)]
    return dict(spheres=spheres, triangles=tris, tri_mats=np.zeros(len(tris), np.int32),
                materials=mats)


@pytest.fixture(scope="module")
def port():
    kw = _mesh_scene_args()
    scene = build_pt_scene(device=CPU, **kw)
    cs = clusters.build_clusters(kw["triangles"], tri_mats=kw["tri_mats"], device=CPU)
    return PTConfig(**SIZE, rng="pcg"), scene, cs, torch.zeros(3), torch.tensor(QUAT)


@pytest.fixture(scope="module")
def jax_render():
    kw = _mesh_scene_args()
    img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), jax_build_pt_scene(**kw),
                                jnp.zeros(3), jnp.asarray(QUAT), 1, jax.random.PRNGKey(SEED))
    return np.asarray(img), float(n)


@pytest.fixture(scope="module")
def mega(port):
    cfg, scene, cs, pos, quat = port
    return pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=cs)


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


def test_rebin_matches_jax(port, jax_render):
    cfg, scene, cs, pos, quat = port
    before = pt.rebin_launches
    got, n = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=cs)
    assert pt.rebin_launches == before  # CPU tensors: the plain version
    assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
    assert (got.amax(-1) > 0).double().mean() > 0.05
    hold_megakernel_bounds(got.numpy(), int(n), *jax_render)


@pytest.mark.parametrize("rebin", MODES)
def test_rebin_equals_mega_bit_for_bit(port, mega, rebin):
    cfg, scene, cs, pos, quat = port
    got, n = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=cs,
                                rebin=rebin)
    assert torch.equal(got, mega[0]) and int(n) == int(mega[1])


def test_rebin_two_passes_equal_mega(port):
    """2 spp from pass 5 on: rebin's acc / 2 and mega's acc * (1/2) agree."""
    cfg, scene, cs, pos, quat = port
    kw = dict(seed=seed_from_int(SEED), bvh=cs, spp_offset=5)
    a, na = pt.render_pt_rebin(cfg, scene, pos, quat, 2, **kw)
    b, nb = pt.render_pt_mega(cfg, scene, pos, quat, 2, **kw)
    assert torch.equal(a, b) and int(na) == int(nb)


def test_band_equals_rows_of_full_render(port):
    cfg, scene, cs, pos, quat = port
    full, n_full = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=7, bvh=cs)
    parts = [pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=7, bvh=cs, row0=r, band_h=4)
             for r in range(0, 16, 4)]
    assert torch.equal(torch.cat([p[0] for p in parts]), full)
    assert sum(int(p[1]) for p in parts) == int(n_full)
    mega_band, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=7, bvh=cs, row0=8,
                                     band_h=4)
    assert torch.equal(mega_band, full[8:12])


def test_fast_path_within_megakernel_bounds(port, mega):
    """render_pt_fast(bvh=cs): the gather path (visit orders from the mean
    live origin, material from the scene) against the attributes path."""
    cfg, scene, cs, pos, quat = port
    got, n = wavefront.render_pt_fast(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED),
                                      bvh=cs)
    hold_megakernel_bounds(got.numpy(), int(n), mega[0].numpy(), int(mega[1]))


@pytest.mark.parametrize("smooth", [False, True])
def test_attrs_path_matches_gather_path(smooth):
    """JAX tests/test_clusters.py:141: _intersect with a ClusterSet (gather)
    and with FrameClusters (attributes) agree, materials alternating."""
    kw = _mesh_scene_args()
    tris = kw["triangles"]
    mats = (np.arange(tris.shape[0]) % 2).astype(np.int32)
    vn = smooth_vertex_normals(tris) if smooth else None
    cs = clusters.build_clusters(tris, tri_mats=mats, vertex_normals=vn, device=CPU)
    assert cs.smooth == smooth
    scene = build_pt_scene(spheres=[((3.0, 3.0, 3.0), 1.0, 1)], triangles=tris, tri_mats=mats,
                           materials=[{"albedo": (0.5,) * 3}, {"albedo": (0.7,) * 3}],
                           device=CPU)
    rng = np.random.default_rng(13)
    d = rng.normal(size=(3, 8, 64)).astype(np.float32)
    d[1] = np.abs(d[1]) * 3.0 + 1.0
    d /= np.linalg.norm(d, axis=0)
    o = tuple(torch.zeros(8, 64) for _ in range(3))
    d = tuple(torch.from_numpy(x) for x in d)
    counts = wavefront._counts(scene)
    a = wavefront._intersect(scene, o, d, 1e-3, counts, cs)
    b = wavefront._intersect(scene, o, d, 1e-3, counts, FrameClusters.at(cs, torch.zeros(3)))
    hit = a["hit"]
    assert torch.equal(hit, b["hit"]) and 0.1 < hit.double().mean() < 0.9
    np.testing.assert_allclose(a["t"][hit], b["t"][hit], rtol=1e-5)
    assert torch.equal(a["mat_id"][hit], b["mat_id"][hit])
    tri = a["is_tri"] & hit
    assert tri.any() and set(a["mat_id"][tri].tolist()) == {0, 1}
    for c in range(3):
        np.testing.assert_allclose(a["n"][c][hit], b["n"][c][hit], atol=1e-5)
    np.testing.assert_allclose(a["light_area"][hit], b["light_area"][hit], rtol=1e-4)


@pytest.mark.parametrize("mode", ["oct", "morton", "oct_morton", "tile_oct"])
def test_rebin_keys_put_dead_rays_last(mode):
    rng = np.random.default_rng(5)
    n = 512
    state = torch.from_numpy(rng.normal(size=(17, n)).astype(np.float32))
    dead = torch.from_numpy(rng.random(n) < 0.4)
    state[0:3, dead] = 1e18
    state[3:6, dead] = float(np.float32(0.5773502691896258))
    tids = torch.arange(n) // pt.REBIN_TILE
    lo, hi = pt.live_bbox(state)
    keys = pt.rebin_keys(state, mode, lo, hi, tids)
    assert keys.dtype == torch.int32
    order = torch.sort(keys, stable=True).indices
    sorted_dead = dead[order]
    if mode == "tile_oct":
        # rays stay in their tile; dead rays carry octant 7 and sink to the
        # tile's tail, where only live rays of octant 7 may sit among them
        octant7 = (state[3:6] > 0).all(0)
        for t in range(n // pt.REBIN_TILE):
            ranks = order[t * pt.REBIN_TILE:(t + 1) * pt.REBIN_TILE]
            assert torch.all(tids[ranks] == t)
            first_dead = int(dead[ranks].nonzero()[0])
            assert torch.all(dead[ranks][first_dead:] | octant7[ranks][first_dead:])
    else:
        k = int((~dead).sum())
        assert not sorted_dead[:k].any() and sorted_dead[k:].all()
    moved = pt.regroup(state, mode)
    assert torch.equal(moved[:, :], state[:, torch.sort(keys, stable=True).indices])


def test_state_pack_round_trip():
    rng = np.random.default_rng(6)
    arr = torch.from_numpy(rng.normal(size=(17, 4, 5)).astype(np.float32))
    arr[12:14] = (arr[12:14] > 0).float()
    arr[15:17] = torch.from_numpy(rng.integers(0, 1000, (2, 4, 5)).astype(np.float32))
    assert torch.equal(wavefront.pack_state(wavefront.unpack_state(arr)), arr)
    assert wavefront.state_plane_count() == 17


def test_progressive_render_with_clusters(port):
    cfg, scene, cs, pos, quat = port
    state = ProgressiveState.start(cfg, pos, quat, key=SEED, device=CPU)
    for state in progressive_render(cfg, scene, state, 3, passes_per_chunk=2, bvh=cs):
        pass
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 3, seed=seed_from_int(SEED), bvh=cs)
    assert state.spp_done == 3
    np.testing.assert_allclose(state.accum.numpy(), (one * 3.0).numpy(),
                               rtol=2 * 3 * 2.0 ** -24, atol=1e-7)


def test_mesh_scene_equals_jax_field_for_field(port):
    """All 320 triangle slots stay in the scene, as in the JAX package; the
    JAX scene carried across renders the same image."""
    import dataclasses

    from raytracing_engine_tpu_torch.pathtracer import pt_scene_from_numpy

    kw = _mesh_scene_args()
    js = jax_build_pt_scene(**kw)
    arrays = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None
              and not isinstance(getattr(js, f.name), (bool, int))}
    carried = pt_scene_from_numpy(arrays, device=CPU)
    cfg, scene, cs, pos, quat = port
    assert scene.tri_v0.shape[0] == kw["triangles"].shape[0] == int(scene.tri_count)
    for name, t in scene.tensors().items():
        assert torch.equal(t, getattr(carried, name)), name
    emissive_mats = [{"albedo": (0.5,) * 3}, {"emission": (1.0,) * 3}]
    mats = np.zeros(kw["triangles"].shape[0], np.int32)
    mats[40] = 1
    with pytest.raises(ValueError, match="TRI_UNROLL_MAX"):
        build_pt_scene(triangles=kw["triangles"], tri_mats=mats, materials=emissive_mats,
                       device=CPU)


def test_gates_of_this_slice(port):
    cfg, scene, cs, pos, quat = port
    with pytest.raises(TypeError, match="ClusterSet"):
        pt.render_pt_rebin(cfg, scene, pos, quat, 1)
    with pytest.raises(ValueError, match="unrolls"):
        pt.render_pt_mega(cfg, scene, pos, quat, 1)  # 320 slots, no ClusterSet
    raw = pbvh.build_bvh(_mesh_scene_args()["triangles"], device=CPU)
    with pytest.raises(TypeError, match="render_pt_fast"):  # a raw BVH: K8, not the megakernels
        pt.render_pt_rebin(cfg, scene, pos, quat, 1, bvh=raw)
    with pytest.raises(NotImplementedError, match="compaction"):
        wavefront.render_pt_fast(cfg, scene, pos, quat, 1, bvh=cs, sort=True)
    with pytest.raises(ValueError, match="rebin mode"):
        pt.render_pt_rebin(cfg, scene, pos, quat, 1, bvh=cs, rebin="none,zigzag")
