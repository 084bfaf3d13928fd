"""Instancing on the CPU (BASELINE config 5): the port's instance tables, its
two-level oracle, kernel K7's plain version, render_instanced_phong and the
path tracer over instances, against the JAX package.

Scene: tests/test_instanced_kernel.py:18-24, six instances (3 x 2) of
icosphere(2) (320 triangles, one super cluster), materials 0, 1, 2 in turn;
rays: a 16x128 grid from a numpy seed, fanned from the origin toward the
instances (tests/test_instanced_kernel.py:27-34), plus parked rays.

- Tables: make_instances (non-unit scales, arbitrary rotations),
  grid_instances, pack_instances and the per-instance visit orders equal
  JAX's field for field; object_space_origins within rtol 1e-6 (XLA fuses
  its einsum into multiply-adds, the port rounds each product as K4 does).
- instanced_intersect (the gather oracle) against JAX's: t within rtol
  1e-6 / atol 1e-6, instance and triangle equal.
- K7's plain version against JAX instanced_cluster_intersect in interpret
  mode (one compile, in a module fixture), closest hit with attributes: t
  within rtol 1e-6 / atol 1e-6, the instance (code // padded_tris) equal,
  normals within atol 1e-6 where the codes agree; on a UV base table with
  tan=True (a second compile) the UV and world tangent planes too. Its any
  hit against the JAX gather oracle (an any-hit interpret compile would
  cost 12 s more): blocked exactly where the oracle's hit is closer than
  the cutoff.
- render_instanced_phong (hard, and soft with 2 samples) and
  render_pt_fast(bvh=InstancedClusters) against the JAX functions, whose
  instanced intersector is routed (for this module's fixtures only) to a
  stand-in over JAX's own two-level gather oracle, which a test holds to
  the JAX kernel: the interpret-mode kernel inside those jitted renders
  costs 25 s a compile. So the JAX side is JAX code throughout, its
  closest and any-hit queries included. Images within rtol 1e-3 / atol
  2e-3 with at most 1e-3 of the pixels off
  (tests/test_parity_jnp_vs_golden.py); the path tracer within the
  megakernel bounds (tests/test_megakernel.py:37-40).
- Inside the port: K5 == K4 with instances bit for bit (their plain
  versions), bands equal the rows of the full render, the public entry
  points refuse the in-kernel views on a CUDA scene.

K7, and the instanced sweep inside K4 and K5, need the card:
chip_smoke.py phase 14 holds them to these plain versions bit for bit.
"""

import dataclasses
import functools
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import build_bvh as jax_build_bvh
from raytracing_engine_tpu.accel import icosphere
from raytracing_engine_tpu.accel import instancing as jinstancing
from raytracing_engine_tpu.accel.clusters import build_clusters as jax_build_clusters
from raytracing_engine_tpu.accel.clusters import visit_orders as jax_visit_orders
from raytracing_engine_tpu.models import instanced as jmodels_instanced
from raytracing_engine_tpu.ops.pallas import instanced_intersect as jii
from raytracing_engine_tpu.ops.pallas.instanced_intersect import (  # bound before `routed`
    instanced_cluster_intersect as jax_kernel_intersect,
)
from raytracing_engine_tpu.pathtracer import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import BVH, cluster_set_from_numpy, clusters, instancing
from raytracing_engine_tpu_torch.accel import build_bvh as accel_build_bvh
from raytracing_engine_tpu_torch.accel.clusters import visit_orders
from raytracing_engine_tpu_torch.models import instanced as pmodels
from raytracing_engine_tpu_torch.ops.cuda import cluster as kcluster
from raytracing_engine_tpu_torch.ops.cuda import common, instanced, pt
from raytracing_engine_tpu_torch.ops.cuda.cluster import FrameClusters
from raytracing_engine_tpu_torch.ops.cuda.instanced import FrameInstances
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene, wavefront

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W = 16, 128
MATS = np.array([0, 1, 2, 0, 1, 2], np.int32)
ALBEDO = np.array([[0.8, 0.6, 0.4], [0.3, 0.6, 0.9], [0.5, 0.5, 0.5]], np.float32)
_BVH_FIELDS = ("bb_min", "bb_max", "first_tri", "tri_count", "skip", "v0", "e1", "e2", "perm")
_CS_FIELDS = ("tri", "boxes", "perm", "centroid", "super_boxes", "super_centroid", "order_refs")


@pytest.fixture(scope="module")
def setup():
    """JAX and port: (mesh, bvh, cs, inst, tab) each, from the same arrays."""
    mesh = icosphere(subdivisions=2, radius=0.8)
    jb = jax_build_bvh(mesh)
    jcs = jax_build_clusters(mesh)
    jinst = jinstancing.grid_instances(jb, nx=3, ny=2, spacing=2.5, base=(0.0, 8.0, 0.0),
                                       mats=MATS)
    jtab = jii.pack_instances(jinst)
    pb = BVH(**{f: torch.from_numpy(np.array(getattr(jb, f))) for f in _BVH_FIELDS})
    pcs = cluster_set_from_numpy({f: np.asarray(getattr(jcs, f)) for f in _CS_FIELDS},
                                 device=CPU)
    pinst = instancing.grid_instances(pb, nx=3, ny=2, spacing=2.5, base=(0.0, 8.0, 0.0),
                                      mats=MATS, device=CPU)
    ptab = instanced.pack_instances(pinst)
    return dict(jax=(jb, jcs, jinst, jtab), port=(pb, pcs, pinst, ptab))


def _rays(h=H, w=W, seed=0, park_rows=2):
    """(o, d) as (3, h, w) float32: tests/test_instanced_kernel.py's fan from
    the origin; the last park_rows rows parked at 1e18."""
    rng = np.random.default_rng(seed)
    o = np.zeros((3, h, w), np.float32)
    tx = rng.normal(0.0, 3.0, size=(h, w)).astype(np.float32)
    ty = np.full((h, w), 9.0, np.float32) + rng.normal(0, 2.0, (h, w)).astype(np.float32)
    tz = rng.normal(0.5, 1.5, size=(h, w)).astype(np.float32)
    n = np.sqrt(tx * tx + ty * ty + tz * tz)
    d = np.stack([tx / n, ty / n, tz / n]).astype(np.float32)
    if park_rows:
        o[:, -park_rows:] = 1e18
        d[:, -park_rows:] = np.float32(0.5773502691896258)
    return o, d


def _torch(x):
    return tuple(torch.from_numpy(np.array(c)) for c in x)  # a writable copy


def _jnp(x):
    return tuple(jnp.asarray(c) for c in x)


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


# --- tables ---------------------------------------------------------------------

def test_grid_instances_and_pack_instances_equal_jax(setup):
    _, _, jinst, jtab = setup["jax"]
    _, _, pinst, ptab = setup["port"]
    for f in ("rot", "inv_rot", "trans", "scale", "mat", "aabb_min", "aabb_max"):
        assert _eq(getattr(jinst, f), getattr(pinst, f)), f
    assert pinst.num_instances == 6 and pinst.total_triangles == 6 * 320
    assert _eq(jtab, ptab) and ptab.shape == (6, 24) and ptab.dtype == torch.float32


def test_make_instances_equal_jax(setup):
    jb = setup["jax"][0]
    pb = setup["port"][0]
    rng = np.random.default_rng(4)
    transforms = []
    for k in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        transforms.append((q.astype(np.float32), rng.normal(0, 3, 3), float(0.5 + 0.5 * k)))
    ji = jinstancing.make_instances(jb, transforms, mats=[3, 1, 2, 0])
    pi = instancing.make_instances(pb, transforms, mats=[3, 1, 2, 0], device=CPU)
    for f in ("rot", "inv_rot", "trans", "scale", "mat", "aabb_min", "aabb_max"):
        assert _eq(getattr(ji, f), getattr(pi, f)), f
    assert _eq(jii.pack_instances(ji), instanced.pack_instances(pi))


def test_object_space_origins_and_visit_orders_equal_jax(setup):
    _, jcs, _, jtab = setup["jax"]
    _, pcs, _, ptab = setup["port"]
    for origin in ([0.0, 0.0, 0.0], [1.5, 6.0, -0.5]):
        jo = np.asarray(jii.object_space_origins(jtab, jnp.asarray(origin, jnp.float32)))
        po = instanced.object_space_origins(ptab, torch.tensor(origin))
        # XLA contracts the einsum's sums into fused multiply-adds; the port
        # rounds each product: equal within an ulp or two, not bit for bit
        np.testing.assert_allclose(po.numpy(), jo, rtol=1e-6, atol=1e-6)
        same_origins = torch.from_numpy(np.array(jo))
        assert _eq(jax_visit_orders(jcs, jnp.asarray(jo)), visit_orders(pcs, same_origins))
        assert _eq(jax_visit_orders(jcs, jnp.asarray(jo)), visit_orders(pcs, po))
        iorder, iorders = instanced.instance_orders(ptab, pcs, torch.tensor(origin))
        center = (np.asarray(jtab)[:, 13:16] + np.asarray(jtab)[:, 16:19]) * 0.5
        dist = ((center - np.float32(origin)) ** 2).sum(-1)
        assert _eq(np.argsort(dist, kind="stable").astype(np.int32), iorder)
        assert torch.equal(iorders, visit_orders(pcs, po))


def test_constructors_default_to_the_card(setup, monkeypatch):
    pb, pcs, pinst, _ = setup["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: instancing.grid_instances(pb, 2, 1),
                 lambda: instancing.make_instances(pb, [(np.eye(3), (0, 0, 0), 1.0)]),
                 lambda: instancing.make_instanced_clusters(pinst, pcs)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_make_instanced_clusters_refuses_emissive_instances(setup):
    _, pcs, pinst, ptab = setup["port"]
    scene = build_pt_scene(spheres=[((0, 0, 0), 1.0, 0)], device=CPU, materials=[
        {"albedo": (0.5,) * 3}, {"emission": (1.0,) * 3}, {"albedo": (0.2,) * 3}])
    with pytest.raises(ValueError, match=r"instances \[1, 4\] use emissive"):
        instancing.make_instanced_clusters(pinst, pcs, scene=scene, device=CPU)
    ic = instancing.make_instanced_clusters(pinst, pcs, device=CPU)
    assert torch.equal(ic.inst_tab, ptab) and ic.cs is pcs and ic.num_instances == 6


# --- the two-level oracle and K7's plain version -----------------------------------

@pytest.fixture(scope="module")
def jax_hits(setup):
    """JAX: the gather oracle and the interpret-mode kernel (attrs) on _rays()."""
    _, jcs, jinst, jtab = setup["jax"]
    o, d = _rays()
    # jitted: op by op the six unrolled traversals cost three times the compile
    gather = jax.jit(lambda o3, d3: jinstancing.instanced_intersect(jinst, o3, d3))(
        jnp.asarray(np.moveaxis(o, 0, -1)), jnp.asarray(np.moveaxis(d, 0, -1)))
    kernel = jii.instanced_cluster_intersect(jtab, jcs, _jnp(o), _jnp(d), attrs=True,
                                             interpret=True)
    return [np.asarray(x) for x in gather], [np.asarray(x) for x in kernel]


def test_instanced_intersect_matches_jax(setup, jax_hits):
    _, _, pinst, _ = setup["port"]
    o, d = _rays()
    got = instancing.instanced_intersect(pinst, torch.from_numpy(np.moveaxis(o, 0, -1).copy()),
                                         torch.from_numpy(np.moveaxis(d, 0, -1).copy()))
    want = jax_hits[0]
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    hit = want[1] >= 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(got[0].numpy()[hit], want[0][hit], rtol=1e-6, atol=1e-6)
    assert np.all(np.isinf(got[0].numpy()[~hit]))
    np.testing.assert_allclose(got[3].numpy()[hit], want[3][hit], atol=1e-5)


def test_k7_plain_matches_the_jax_kernel(setup, jax_hits):
    _, pcs, _, ptab = setup["port"]
    o, d = _rays()
    got = [x.numpy() for x in instanced.instanced_cluster_intersect_reference(
        ptab, pcs, _torch(o), _torch(d), attrs=True)]
    want = jax_hits[1]
    assert got[1].dtype == np.int32
    hit = want[1] >= 0
    np.testing.assert_array_equal(got[1] >= 0, hit)
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6, atol=1e-6)
    assert np.all(np.isinf(got[0][~hit])) and np.all(got[1][~hit] == -1)
    t_pad = pcs.padded_tris
    np.testing.assert_array_equal(got[1][hit] // t_pad, want[1][hit] // t_pad)
    same = (got[1] == want[1]) & hit
    assert same.mean() / hit.mean() >= 0.99
    for a in range(2, 5):
        np.testing.assert_allclose(got[a][same], want[a][same], atol=1e-6, rtol=0.0)
        assert np.all(got[a][~hit] == 0.0)
    # the gather oracle agrees on the instance of each hit
    np.testing.assert_array_equal(got[1][hit] // t_pad, jax_hits[0][1][hit])


def test_k7_plain_any_hit(setup, jax_hits):
    """Blocked exactly where the JAX oracle's closest hit lies below the
    cutoff; parked rays count as blocked at t_max with code 0."""
    _, pcs, _, ptab = setup["port"]
    o, d = _rays()
    cut = np.random.default_rng(8).uniform(7.0, 11.0, (H, W)).astype(np.float32)
    t, code = instanced.instanced_cluster_intersect_reference(
        ptab, pcs, _torch(o), _torch(d), any_hit=True, t_max=torch.from_numpy(cut))
    live = slice(0, H - 2)
    want = jax_hits[0][0][live] < cut[live]
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(code.numpy()[live] >= 0, want)
    assert np.all(code.numpy()[H - 2:] == 0) and np.array_equal(t.numpy()[H - 2:], cut[H - 2:])


def test_k7_orders_change_no_result(setup):
    """Near-to-far orders from an origin (per-instance object-space super
    orders) give the same t and codes as the identity orders."""
    _, pcs, _, ptab = setup["port"]
    o, d = _rays(seed=2)
    a = instanced.instanced_cluster_intersect(ptab, pcs, _torch(o), _torch(d), attrs=True)
    b = instanced.instanced_cluster_intersect(ptab, pcs, _torch(o), _torch(d), attrs=True,
                                              origin=torch.zeros(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("any_hit", [False, True])
def test_k7_plain_keeps_the_sets_tie_rule(any_hit):
    """One instance at the identity of the set whose every triangle is there
    twice (tests/test_torch_cluster.py::test_batched_selection_equals_sequential_scan):
    every hit is an exact tie, and K7's plain version keeps the slot, and the
    t, that the set's own sweep keeps in the instance's super order. K7's
    warp reduction holds this rule on the card (chip_smoke.py phase 14)."""
    tris = icosphere(1, radius=1.2, center=(0.0, 8.0, 0.0))
    dup = np.concatenate([tris, tris])
    cs = clusters.build_clusters(dup, device=CPU)
    inst = instancing.make_instances(accel_build_bvh(dup, device=CPU),
                                     [(np.eye(3, dtype=np.float32), (0.0, 0.0, 0.0), 1.0)],
                                     device=CPU)
    tab = instanced.pack_instances(inst)
    iorder, iorders = instanced.instance_orders(tab, cs, torch.zeros(3))
    o, d = _rays(seed=3)
    t_max = 9.0 if any_hit else float("inf")
    t, code = instanced.instanced_cluster_intersect_reference(
        tab, cs, _torch(o), _torch(d), any_hit=any_hit, t_max=t_max, iorder=iorder,
        iorders=iorders)
    want_t, want_i = kcluster.cluster_intersect_reference(cs, _torch(o), _torch(d), t_max,
                                                          any_hit=any_hit, order=iorders[0])
    assert torch.equal(code, want_i) and torch.equal(t, want_t)
    assert (code[:H - 2] >= 0).sum() > 100


def test_wrapper_on_cpu_is_its_plain_version(setup):
    _, pcs, _, ptab = setup["port"]
    o, d = _rays(seed=1)
    before = instanced.launches
    instanced.work.update(gates=0, transforms=0)
    for kw in (dict(attrs=True), dict(any_hit=True, t_max=9.0)):
        a = instanced.instanced_cluster_intersect(ptab, pcs, _torch(o), _torch(d), **kw)
        b = instanced.instanced_cluster_intersect_reference(ptab, pcs, _torch(o), _torch(d),
                                                            **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert instanced.launches == before
    assert instanced.work["gates"] >= 6 * (H - 2) * W and 0 < instanced.work["transforms"]


def _struct_fields(src, name):
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*[,;]", body)


def test_instanced_args_mirror_the_cuda_structs():
    cuh = (common.CSRC_DIR / "instanced.cuh").read_text()
    cu = (common.CSRC_DIR / "instanced.cu").read_text()
    assert _struct_fields(cuh, "Instances") == [f for f, _ in instanced.InstanceTables._fields_]
    assert _struct_fields(cu, "Args") == [f for f, _ in instanced.InstancedArgs._fields_]


# --- JAX renders with the intersector routed to JAX's two-level oracle ---------------

def _oracle_intersector(jinst, jcs):
    """A stand-in for JAX instanced_cluster_intersect (same arguments and
    results) built on the JAX package's own two-level gather oracle,
    accel/instancing.instanced_intersect: code = instance * padded_tris +
    the triangle's slot in the ClusterSet (through cs.perm), the world
    normal (unit length; every caller normalizes it). Closest hits beyond
    t_max are misses; any hit blocks where the closest hit lies below t_max,
    and a parked ray (|o.x| >= 1e17) counts as blocked at t_max with code 0,
    as in the kernel's instanced_sweep. The oracle is jitted on its own and
    reached through jax.pure_callback, so each query shape compiles once
    for every render of the module instead of once inside each."""
    perm = np.asarray(jcs.perm)
    slot_of = np.full(int(perm.max()) + 1, -1, np.int32)
    live = perm >= 0
    slot_of[perm[live]] = np.nonzero(live)[0]
    slot_of = jnp.asarray(slot_of)
    bvh_perm = jnp.asarray(jinst.bvh.perm)
    t_pad = jcs.padded_tris

    @functools.partial(jax.jit, static_argnames=("t_min", "any_hit", "attrs"))
    def oracle(ox, oy, oz, dx, dy, dz, tm, t_min, any_hit, attrs):
        t, k, tri, n = jinstancing.instanced_intersect(
            jinst, jnp.stack((ox, oy, oz), -1), jnp.stack((dx, dy, dz), -1), t_min=t_min)
        hit = (k >= 0) & (t < tm)
        code = jnp.where(hit, k * t_pad + slot_of[bvh_perm[jnp.maximum(tri, 0)]], -1)
        if any_hit:
            parked = jnp.abs(ox) >= 1e17
            code = jnp.where(parked, 0, code)
            t = jnp.where(parked, tm, t)
        code = code.astype(jnp.int32)
        t = jnp.where(code >= 0, t, jnp.inf)
        if not attrs:
            return t, code
        return (t, code) + tuple(jnp.where(hit, n[..., a], 0.0) for a in range(3))

    def intersect(inst_tab, cs, o_planes, d_planes, t_min=1e-3, tile=(16, 256),
                  interpret=None, any_hit=False, attrs=False, t_max=np.inf, origin=None,
                  tan=False):
        shape = o_planes[0].shape
        outs = [jax.ShapeDtypeStruct(shape, jnp.float32), jax.ShapeDtypeStruct(shape, jnp.int32)]
        if attrs:
            outs += [jax.ShapeDtypeStruct(shape, jnp.float32)] * 3
        tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape)

        def cb(*planes):
            res = oracle(*planes, t_min=t_min, any_hit=any_hit, attrs=attrs)
            return tuple(np.asarray(x) for x in res)

        return jax.pure_callback(cb, tuple(outs), *o_planes, *d_planes, tm)
    return intersect


def test_oracle_stand_in_matches_the_jax_kernel(setup, jax_hits):
    """The stand-in the renders below use agrees with JAX's interpret-mode
    kernel on the same rays: t within rtol 1e-6 / atol 1e-6, the instance
    equal, the slot equal on at least 99% of the hits (a ray through a
    shared edge may take the neighbouring triangle), the normals parallel
    where the slots agree."""
    _, jcs, jinst, jtab = setup["jax"]
    o, d = _rays()
    got = [np.asarray(x) for x in _oracle_intersector(jinst, jcs)(
        jtab, jcs, _jnp(o), _jnp(d), attrs=True)]
    want = jax_hits[1]
    hit = want[1] >= 0
    np.testing.assert_array_equal(got[1] >= 0, hit)
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6, atol=1e-6)
    t_pad = jcs.padded_tris
    np.testing.assert_array_equal(got[1][hit] // t_pad, want[1][hit] // t_pad)
    same = (got[1] == want[1]) & hit
    assert same.sum() >= 0.99 * hit.sum()
    wn = np.stack(want[2:5], -1)[same]
    wn /= np.linalg.norm(wn, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.stack(got[2:5], -1)[same], wn, atol=1e-5)


@pytest.fixture(scope="module")
def routed(setup):
    """Patch the JAX package's instanced intersector (by module attribute,
    for this module only) with the oracle stand-in, and drop every jit cache
    before and after so no other test sees a routed trace."""
    _, jcs, jinst, _ = setup["jax"]
    fn = _oracle_intersector(jinst, jcs)
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jii, "instanced_cluster_intersect", fn)
        mp.setattr(jmodels_instanced, "instanced_cluster_intersect", fn)
        yield
    jax.clear_caches()


PHONG = dict(width=64, height=32, light_color=(120.0, 120.0, 110.0))
LIGHT = (0.0, 4.0, 6.0)


@pytest.fixture(scope="module")
def jax_phong(setup, routed):
    _, jcs, jinst, jtab = setup["jax"]
    args = (jtab, jcs, jinst.mat, jnp.asarray(ALBEDO), jnp.zeros(3), jnp.float32(0.2),
            jnp.asarray(LIGHT))
    hard = jmodels_instanced.render_instanced_phong(*args, shadows=True, **PHONG)
    soft = jmodels_instanced.render_instanced_phong(*args, shadows=True, light_radius=1.5,
                                                    shadow_samples=2, seed=5, **PHONG)
    return np.asarray(hard), np.asarray(soft)


def _phong(setup, **kw):
    _, pcs, pinst, ptab = setup["port"]
    return pmodels.render_instanced_phong(ptab, pcs, pinst.mat, torch.from_numpy(ALBEDO),
                                          torch.zeros(3), 0.2, torch.tensor(LIGHT),
                                          **{**PHONG, **kw})


def hold_image(got, want):
    """tests/test_parity_jnp_vs_golden.py's image bound."""
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=1e-3, atol=2e-3)
    assert bad.mean() <= 1e-3, f"{bad.mean():.4%} of elements off"


@pytest.mark.parametrize("soft", [False, True])
def test_render_instanced_phong_matches_jax(setup, jax_phong, soft):
    kw = dict(light_radius=1.5, shadow_samples=2, seed=5) if soft else {}
    got = _phong(setup, shadows=True, **kw).numpy()
    want = jax_phong[1 if soft else 0]
    assert (got > 0).mean() > 0.05
    hold_image(got, want)


def test_phong_bands_shadows_and_samples(setup):
    full = _phong(setup, shadows=True, light_radius=1.5, shadow_samples=2, seed=5)
    band = _phong(setup, shadows=True, light_radius=1.5, shadow_samples=2, seed=5, row0=8,
                  band_h=16)
    assert torch.equal(band, full[8:24])
    hard = _phong(setup, shadows=True)
    none = _phong(setup, shadows=False)
    assert torch.equal(_phong(setup, shadows=True, light_radius=0.0, shadow_samples=4), hard)
    assert torch.all(hard <= none + 1e-6) and torch.any(hard < none - 1e-4)
    assert torch.all(full <= none + 1e-5)


# --- the path tracer over instances ---------------------------------------------

SIZE = dict(width=32, height=16, max_bounces=2)
QUAT = (0.0, 0.0, 0.0, 1.0)
SEED = 3
PT_MATS = [{"albedo": (0.75, 0.5, 0.3), "kind": DIFFUSE},
           {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
           {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
           {"albedo": (0, 0, 0), "emission": (10.0, 9.5, 8.5), "kind": DIFFUSE},
           {"albedo": (0.55, 0.55, 0.5), "kind": DIFFUSE}]
PT_SPHERES = [((3.0, 6.0, 4.0), 1.0, 3), ((0.0, 8.0, -52.0), 50.0, 4)]


@pytest.fixture(scope="module")
def pt_port(setup):
    _, pcs, pinst, _ = setup["port"]
    scene = build_pt_scene(spheres=PT_SPHERES, materials=PT_MATS, device=CPU)
    ic = instancing.make_instanced_clusters(pinst, pcs, scene=scene, device=CPU)
    return PTConfig(**SIZE, rng="pcg"), scene, ic, torch.zeros(3), torch.tensor(QUAT)


@pytest.fixture(scope="module")
def pt_jax(setup, routed):
    _, jcs, jinst, _ = setup["jax"]
    scene = jax_build_pt_scene(spheres=PT_SPHERES, materials=PT_MATS)
    ic = jinstancing.make_instanced_clusters(jinst, jcs, scene=scene)
    img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), scene, jnp.zeros(3),
                                jnp.asarray(QUAT), 1, jax.random.PRNGKey(SEED), bvh=ic)
    return np.asarray(img), float(n)


@pytest.fixture(scope="module")
def pt_mega(pt_port):
    cfg, scene, ic, pos, quat = pt_port
    return pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=ic)


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


def test_render_pt_fast_with_instances_matches_jax(pt_port, pt_jax, pt_mega):
    cfg, scene, ic, pos, quat = pt_port
    got, n = wavefront.render_pt_fast(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=ic)
    assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
    inst_lit = (got.amax(-1) > 0).double().mean()
    assert inst_lit > 0.1
    hold_megakernel_bounds(got.numpy(), int(n), *pt_jax)
    # the megakernel's plain version (FrameInstances: the camera's orders)
    hold_megakernel_bounds(got.numpy(), int(n), pt_mega[0].numpy(), int(pt_mega[1]))


@pytest.mark.parametrize("rebin", ["none,morton", "oct", "tile_oct"])
def test_rebin_equals_mega_with_instances(pt_port, pt_mega, rebin):
    cfg, scene, ic, pos, quat = pt_port
    got, n = pt.render_pt_rebin(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=ic,
                                rebin=rebin)
    assert torch.equal(got, pt_mega[0]) and int(n) == int(pt_mega[1])


def test_instanced_bands_and_materials(pt_port, pt_mega):
    cfg, scene, ic, pos, quat = pt_port
    band, _ = pt.render_pt_mega(cfg, scene, pos, quat, 1, seed=seed_from_int(SEED), bvh=ic,
                                row0=4, band_h=8)
    assert torch.equal(band, pt_mega[0][4:12])
    # materials per instance (table column 19) and light area 1 on mesh hits
    o, d = _rays(8, 64, seed=13, park_rows=0)
    isect = wavefront._intersect(scene, _torch(o), _torch(d), 1e-3, wavefront._counts(scene),
                                 FrameInstances.at(ic, torch.zeros(3)))
    tri = isect["is_tri"] & isect["hit"]
    assert tri.any() and set(isect["mat_id"][tri].tolist()) == {0, 1, 2}
    assert torch.all(isect["light_area"][tri] == 1.0)
    gather = wavefront._intersect(scene, _torch(o), _torch(d), 1e-3, wavefront._counts(scene), ic)
    for k in ("t", "mat_id", "light_area"):
        assert torch.equal(isect[k], gather[k]), k


def test_progressive_render_with_instances(pt_port):
    """progressive_render(bvh=InstancedClusters) in chunks of 2 equals one
    3-spp render within the float-summation bound."""
    from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

    cfg, scene, ic, pos, quat = pt_port
    state = ProgressiveState.start(cfg, pos, quat, key=SEED, device=CPU)
    for state in progressive_render(cfg, scene, state, 3, passes_per_chunk=2, bvh=ic):
        pass
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 3, seed=seed_from_int(SEED), bvh=ic)
    assert state.spp_done == 3
    np.testing.assert_allclose(state.accum.numpy(), (one * 3.0).numpy(),
                               rtol=2 * 3 * 2.0 ** -24, atol=1e-7)


def test_uv_base_tables_are_not_ported_yet(setup):
    """Instances of a UV ClusterSet (the module's icosphere with spherical
    UVs): K7's plain sweep returns the UV (object-space data, carried
    untransformed) and the world tangent R (du1 r1 + du2 r2). Its ten planes
    against JAX's instanced_cluster_intersect(attrs=True, tan=True) in
    interpret mode: the same hits and instances, t within rtol 1e-6 / atol
    1e-6, the code equal on >= 99% of the hits (a ray through a shared edge
    may take the neighbouring triangle) and there the normal and the
    tangent within atol 1e-6, the UV within atol 2e-6 (it is read at the
    hit point: t's rtol 1e-6 at t of about 9 moves that point by up to
    9e-6 in world units, and the UV changes by about 0.2-0.4 a unit on this
    sphere), 0 on misses. The hits are those of the set
    without UVs. A second witness, JAX's jnp intersector
    (wavefront._intersect, its stacked path) on the six instances
    flattened into world-space triangles: on the rays that hit the same
    triangle, t within rtol 1e-6, UV and tangent within atol 1e-5 (the
    world triangle's own gradients against the rotated object ones). Then
    a UV-textured, normal-mapped render over the instances through the
    plain render_pt_fast and render_pt_mega (within
    tests/test_megakernel.py:37-40's bounds of each other) and the rebin
    route, bit for bit the megakernel."""
    from raytracing_engine_tpu.pathtracer import wavefront as jwave

    from raytracing_engine_tpu_torch.accel import build_clusters

    _, _, jinst, _ = setup["jax"]
    pb, pcs, pinst, ptab = setup["port"]
    mesh = icosphere(subdivisions=2, radius=0.8).astype(np.float32)
    p = mesh / np.linalg.norm(mesh, axis=-1, keepdims=True)
    uvs = np.stack([np.arctan2(p[..., 1], p[..., 0]) / (2.0 * np.pi) + 0.5,
                    np.arccos(np.clip(p[..., 2], -1.0, 1.0)) / np.pi], -1).astype(np.float32)
    cs_uv = build_clusters(mesh, vertex_uvs=uvs, device=CPU)
    o, d = _rays()
    got = [x.numpy() for x in instanced.instanced_cluster_intersect(
        ptab, cs_uv, _torch(o), _torch(d), attrs=True, tan=True)]
    flat = instanced.instanced_cluster_intersect(ptab, pcs, _torch(o), _torch(d), attrs=True)
    assert len(got) == 10
    np.testing.assert_array_equal(got[0], flat[0].numpy())
    np.testing.assert_array_equal(got[1] // cs_uv.padded_tris, flat[1].numpy() // pcs.padded_tris)
    jcs_uv = jax_build_clusters(mesh, vertex_uvs=uvs)
    want = [np.asarray(x) for x in jax_kernel_intersect(
        setup["jax"][3], jcs_uv, _jnp(o), _jnp(d), attrs=True, tan=True, interpret=True)]
    assert len(want) == 10
    hit = want[1] >= 0
    np.testing.assert_array_equal(got[1] >= 0, hit)
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6, atol=1e-6)
    t_pad = cs_uv.padded_tris
    np.testing.assert_array_equal(got[1][hit] // t_pad, want[1][hit] // t_pad)
    same = (got[1] == want[1]) & hit
    assert same.sum() >= 0.99 * hit.sum()
    for a in range(2, 10):  # nx, ny, nz, u, v, tx, ty, tz
        tol = 2e-6 if a in (5, 6) else 1e-6
        np.testing.assert_allclose(got[a][same], want[a][same], atol=tol, rtol=0.0)
        assert np.all(got[a][~hit] == 0.0)
    assert np.ptp(got[5][hit]) > 0.1 and np.abs(np.stack(got[7:10])).max() > 0.1
    # the six instances in world space, per-corner UVs copied
    rot, trans = np.asarray(jinst.rot), np.asarray(jinst.trans)
    world = np.concatenate([mesh @ r.T + t for r, t in zip(rot, trans)]).astype(np.float32)
    tex = np.random.default_rng(3).uniform(0.0, 1.0, (6, 10, 3)).astype(np.float32)
    nrm = np.float32([0.4, -0.3, 1.0]) / np.linalg.norm([0.4, -0.3, 1.0])
    mats = [{"albedo": (0.75, 0.5, 0.3), "image": {"pixels": tex, "scale": 2.0},
             "normal": np.broadcast_to((nrm + 1.0) * 0.5, (2, 2, 3)).astype(np.float32)},
            *PT_MATS[1:]]
    js = jax_build_pt_scene(spheres=PT_SPHERES, materials=mats, triangles=world,
                            tri_mats=np.zeros(len(world), np.int32),
                            tri_uvs=np.concatenate([uvs] * len(rot)))
    jd = tuple(jnp.asarray(x) for x in d)
    # jitted: op by op the stacked intersector costs several times its compile
    isect = jax.jit(lambda o3, d3: jwave._intersect(js, o3, d3, 1e-3, None))(
        tuple(jnp.asarray(x) for x in o), jd)
    jt = np.asarray(isect["t"])
    jtri = np.asarray(isect["is_tri"]) & np.asarray(isect["hit"])
    hit = got[1] >= 0
    np.testing.assert_array_equal(hit[:-2], jtri[:-2])  # the parked rows hit nothing in JAX
    np.testing.assert_allclose(got[0][hit], jt[hit], rtol=1e-6, atol=1e-6)
    juv = np.stack([np.asarray(x) for x in isect["uv"]])
    jtan = np.stack([np.asarray(x) for x in isect["tan"]])
    near = hit & (np.abs(juv - np.stack(got[5:7])).max(0) < 1e-3)
    assert near.sum() >= 0.98 * hit.sum()  # elsewhere a seam's neighbour triangle
    np.testing.assert_allclose(np.stack(got[5:7])[:, near], juv[:, near], atol=1e-5, rtol=0.0)
    np.testing.assert_allclose(np.stack(got[7:10])[:, near], jtan[:, near], atol=1e-5, rtol=0.0)
    assert np.all(np.stack(got[5:10])[:, ~hit] == 0.0)

    # the UV-textured, normal-mapped render over the instances: the plain
    # wavefront and megakernel within the megakernel bounds of each other,
    # the rebin route bit for bit the megakernel (JAX's render of such a
    # scene: tests/test_torch_normal_map.py and tests/test_torch_mips.py)
    scene = build_pt_scene(spheres=PT_SPHERES, materials=mats, device=CPU)
    ic = instancing.make_instanced_clusters(
        instancing.grid_instances(pb, nx=3, ny=2, spacing=2.5, base=(0.0, 8.0, 0.0),
                                  mats=np.zeros(6, np.int32), device=CPU), cs_uv, scene=scene,
        device=CPU)
    assert scene.needs_tan and pt.uses_tex_instantiation(scene, ic)
    cfg = PTConfig(**SIZE, rng="pcg", tex_filter="bilinear")
    args = (cfg, scene, torch.zeros(3), torch.tensor(QUAT), 1)
    fast = wavefront.render_pt_fast(*args, seed=seed_from_int(SEED), bvh=ic)
    mega = pt.render_pt_mega(*args, seed=seed_from_int(SEED), bvh=ic)
    hold_megakernel_bounds(fast[0].numpy(), int(fast[1]), mega[0].numpy(), int(mega[1]))
    rb = pt.render_pt_rebin(*args, seed=seed_from_int(SEED), bvh=ic)
    assert torch.equal(rb[0], mega[0]) and int(rb[1]) == int(mega[1])
    flat_scene = build_pt_scene(spheres=PT_SPHERES, materials=PT_MATS, device=CPU)
    untextured = pt.render_pt_mega(cfg, flat_scene, *args[2:], seed=seed_from_int(SEED), bvh=ic)
    assert (mega[0] - untextured[0]).abs().max() > 1e-2  # the textures show


def test_entry_points_refuse_in_kernel_views_on_a_cuda_scene(pt_port):
    """The frame views run the plain sweeps: the public entry points refuse
    them on a CUDA scene (a stand-in reports the device), and take them on
    the CPU, where they are the kernels' oracles."""
    cfg, scene, ic, pos, quat = pt_port
    views = [FrameClusters.at(ic.cs, pos), FrameInstances.at(ic, pos)]
    cuda_scene = types.SimpleNamespace(device=torch.device("cuda"))
    for view in views:
        with pytest.raises(TypeError, match="in-kernel view"):
            wavefront.render_pt_fast(cfg, cuda_scene, pos, quat, 1, bvh=view)
        with pytest.raises(TypeError, match="in-kernel view"):
            wavefront.trace_pass_soa(cfg, cuda_scene, pos, quat, seed0=0, bvh=view)
    img, _ = wavefront.render_pt_fast(dataclasses.replace(cfg, max_bounces=0), scene, pos, quat,
                                      1, bvh=views[1])
    assert torch.isfinite(img).all()


def test_megakernels_refuse_a_raw_bvh(setup, pt_port):
    cfg, scene, _, pos, quat = pt_port
    pb = setup["port"][0]
    for fn in (pt.render_pt_mega, pt.render_pt_rebin):
        with pytest.raises(TypeError, match="render_pt_fast"):
            fn(cfg, scene, pos, quat, 1, bvh=pb)


def test_slice_modules_import_without_jax():
    """tests/test_torch_isolation.py's probe walks every module; this one
    names the slice's modules, so none of them can drop out of the walk."""
    import subprocess
    import sys
    from pathlib import Path

    probe = r"""
import importlib, sys
BLOCKED = ("jax", "jaxlib", "raytracing_engine_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for m in ("accel.instancing", "models.instanced", "ops.cuda.bvh_traverse", "ops.cuda.instanced"):
    importlib.import_module("raytracing_engine_tpu_torch." + m)
print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
