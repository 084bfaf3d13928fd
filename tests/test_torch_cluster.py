"""Kernel K6's plain version (ops/cuda/cluster.py) against the JAX package's
cluster_intersect in interpret mode, as tests/test_clusters.py runs it.

One 16x16 grid of rays, drawn from a numpy seed, against icosphere(2) (320
triangles, 3 live clusters padded to 8, so 5 all-NaN boxes): rows 0-7 aim at
the mesh from 2.5 units out, rows 8-11 are axis-parallel (exact zero and
negative-zero direction components, so 0 * inf = NaN reaches the slab
test), rows 12-15 are parked at 1e18 as the wavefront parks dead rays. Both
sweeps visit the super clusters in the same default order.

Tolerances: t equal or within rtol 1e-6 (XLA may round the interpret-mode
arithmetic differently); the hit slot equal except where two triangles meet
a ray at the same t (the measured agreement is asserted at >= 99% and is
100% on this grid); attributes within atol 1e-6 where the slots agree. The
batched selection of the plain sweep is also held, bit for bit, to a
sequential per-ray scan written out in numpy, on a mesh whose every
triangle is duplicated (every hit is an exact tie).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_engine_tpu.accel import clusters as jclusters
from raytracing_engine_tpu.accel import icosphere
from raytracing_engine_tpu.ops.pallas.cluster_intersect import cluster_intersect as jax_ci

from raytracing_engine_tpu_torch.accel import clusters, mesh
from raytracing_engine_tpu_torch.ops.cuda import cluster, common

torch.set_num_threads(1)
CPU = torch.device("cpu")
CENTER = np.array([0.0, 5.0, 0.0], np.float32)
H = W = 16
T_MAX_ANY = 2.0
INV_SQRT3 = np.float32(0.5773502691896258)


def _rays(seed=0):
    """(o, d) as (3, 16, 16) float32 arrays; see the module docstring."""
    rng = np.random.default_rng(seed)
    o = np.zeros((3, H, W), np.float32)
    d = np.zeros((3, H, W), np.float32)
    u = rng.normal(size=(3, 8, W))
    u /= np.linalg.norm(u, axis=0)
    o[:, :8] = CENTER[:, None, None] + 2.5 * u
    aim = CENTER[:, None, None] + rng.normal(0.0, 0.5, (3, 8, W)) - o[:, :8]
    d[:, :8] = aim / np.linalg.norm(aim, axis=0)
    for k in range(4 * W):  # axis-parallel rows 8-11
        r, c = 8 + k // W, k % W
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0  # the ray runs in a box face's plane
        o[:, r, c] = CENTER + off
        d[:, r, c] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    o[:, 12:] = 1e18
    d[:, 12:] = INV_SQRT3
    return o, d


@pytest.fixture(scope="module")
def sets():
    tris = icosphere(subdivisions=2, radius=1.2, center=tuple(CENTER))
    mats = (np.arange(tris.shape[0]) % 2).astype(np.int32)
    jcs = jclusters.build_clusters(tris, tri_mats=mats)
    cs = clusters.build_clusters(tris, tri_mats=mats, device=CPU)
    return jcs, cs


@pytest.fixture(scope="module")
def jax_sweeps(sets):
    """The JAX sweeps of the grid (interpret mode, one compile each)."""
    jcs, _ = sets
    o, d = _rays()
    jo, jd = tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d)
    closest = jax_ci(jcs, jo, jd, jnp.inf, attrs=True, interpret=True)
    any_hit = jax_ci(jcs, jo, jd, T_MAX_ANY, any_hit=True, interpret=True)
    return ([np.asarray(x) for x in closest], [np.asarray(x) for x in any_hit])


def _port(cs, t_max, **kw):
    o, d = _rays()
    out = cluster.cluster_intersect(cs, tuple(torch.from_numpy(x) for x in o),
                                    tuple(torch.from_numpy(x) for x in d), t_max, **kw)
    return [x.numpy() for x in out]


def _hold_t_idx(got, want, rows=slice(None)):
    """t equal or within rtol 1e-6 and the slots' agreement; -> agreement."""
    gt, gi, wt, wi = got[0][rows], got[1][rows], want[0][rows], want[1][rows]
    assert np.array_equal(gi >= 0, wi >= 0)
    hit = wi >= 0
    assert np.array_equal(np.isinf(gt), np.isinf(wt))
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=1e-6, atol=0.0)
    agree = float((gi[hit] == wi[hit]).mean()) if hit.any() else 1.0
    assert agree >= 0.99, f"slots agree on {agree:.2%} of hits"
    return agree


def test_closest_with_attrs_matches_jax(sets, jax_sweeps):
    got = _port(sets[1], float("inf"), attrs=True)
    want = jax_sweeps[0]
    assert got[1].dtype == np.int32 and got[0].shape == (H, W)
    agree = _hold_t_idx(got, want)
    same = (got[1] == want[1]) & (want[1] >= 0)
    assert same.sum() > 40, "too few hits to mean anything"
    for a in range(2, 7):  # nx, ny, nz, mat, area
        np.testing.assert_allclose(got[a][same], want[a][same], atol=1e-6, rtol=0.0)
        assert np.all(got[a][want[1] < 0] == 0.0)
    assert agree == 1.0


def test_any_hit_matches_jax(sets, jax_sweeps):
    got = _port(sets[1], T_MAX_ANY, any_hit=True)
    want = jax_sweeps[1]
    _hold_t_idx(got, want, slice(0, 12))
    blocked = got[1][:12] >= 0
    assert 0 < blocked.mean() < 1, "t_max = 2 should cut some rays and not others"


def test_axis_parallel_rows_match_jax(sets, jax_sweeps):
    got = _port(sets[1], float("inf"), attrs=True)
    hits = got[1][8:12] >= 0
    assert hits.any() and not hits.all()
    assert _hold_t_idx(got, jax_sweeps[0], slice(8, 12)) == 1.0


def test_parked_rows(sets, jax_sweeps):
    """Parked rays miss a closest sweep and count as blocked at t_max in an
    any-hit sweep (slot 0), as in the JAX sweep."""
    closest = _port(sets[1], float("inf"), attrs=True)
    any_hit = _port(sets[1], T_MAX_ANY, any_hit=True)
    assert np.all(closest[1][12:] == -1) and np.all(np.isinf(closest[0][12:]))
    assert np.all(any_hit[1][12:] == 0) and np.all(any_hit[0][12:] == np.float32(T_MAX_ANY))
    for got, want in ((closest, jax_sweeps[0]), (any_hit, jax_sweeps[1])):
        assert np.array_equal(got[0][12:], want[0][12:])
        assert np.array_equal(got[1][12:], want[1][12:])


def test_per_ray_orders_match_jax(sets, jax_sweeps):
    """Each ray's own visit order (the reference nearest its origin) against
    the JAX sweep's single order: the same t and, away from ties, slots."""
    cs = sets[1]
    fc = cluster.FrameClusters.at(cs, torch.from_numpy(CENTER))
    assert fc.orders.shape == (1 + cs.order_refs.shape[0], cs.num_super)
    got = _port(cs, float("inf"), attrs=True, order=fc.orders[0], orders=fc.orders,
                refs=fc.refs)
    assert _hold_t_idx(got, jax_sweeps[0]) == 1.0


def test_wrapper_on_cpu_is_its_plain_version(sets):
    cs = sets[1]
    o, d = _rays(1)
    o, d = tuple(torch.from_numpy(x) for x in o), tuple(torch.from_numpy(x) for x in d)
    before = cluster.launches
    a = cluster.cluster_intersect(cs, o, d, 3.0, attrs=True)
    b = cluster.cluster_intersect_reference(cs, o, d, 3.0, attrs=True)
    assert cluster.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sweep_tables_layout(sets):
    cs = sets[1]
    tb = cluster.sweep_tables(cs)
    assert cluster.sweep_tables(cs) is tb  # built once per ClusterSet
    assert torch.equal(tb.trec[:, :14], cs.tri[:14].T) and torch.all(tb.trec[:, 14:] == 0)
    assert tb.tsmooth is None
    for c in range(cs.num_clusters):
        rec = tb.crec[c]
        assert torch.equal(rec[:6], cs.boxes[c, :6]) or torch.isnan(cs.boxes[c, 0])
        assert torch.equal(rec[8:11], cs.tri[20, c * 128:c * 128 + 3])
        for s in range(4):
            want = cs.tri[14:20, c * 128 + s]
            got = rec[12 + 6 * s:18 + 6 * s]
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got[~got.isnan()], want[~want.isnan()])


def test_uv_tables_are_not_ported_yet():
    """K6's texture-u tangent planes on a UV table (tan=True: normal maps and
    mip LOD) from the rows the table already holds: twelve planes, the first
    nine those of the tan=False sweep bit for bit. Against JAX's ClusterSet
    hit path (wavefront._tri_hits of a normal-mapped scene: its
    interpret-mode closest sweep, then JAX's du1 r1 + du2 r2 from the hit
    slot's rows): the same hits, the same triangle on >= 99% of them (a
    tie may go either way), t within rtol 1e-6 and the tangent within atol
    1e-6 there; bit for bit the port's own gather path
    (wavefront._tri_hits_clusters); 0 on misses; a table without UVs
    ignores tan, as JAX's does. tests/test_torch_textures.py holds all
    twelve planes to JAX's cluster_intersect(tan=True)."""
    from raytracing_engine_tpu.pathtracer import wavefront as jwave
    from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene

    from raytracing_engine_tpu_torch.pathtracer import wavefront

    rng = np.random.default_rng(6)
    tris = mesh.icosphere(2, radius=1.2, center=tuple(CENTER))
    uvs = rng.uniform(-0.5, 1.5, (tris.shape[0], 3, 2)).astype(np.float32)
    cs = clusters.build_clusters(tris, vertex_uvs=uvs, device=CPU)
    jcs = jclusters.build_clusters(tris, vertex_uvs=uvs)
    o, d = (tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x) for x in _rays())
    got = cluster.cluster_intersect(cs, o, d, float("inf"), attrs=True, tan=True)
    base = cluster.cluster_intersect(cs, o, d, float("inf"), attrs=True)
    assert len(got) == 12 and len(base) == 9
    assert all(torch.equal(a, b) for a, b in zip(got[:9], base))
    slot = got[1]
    hit = (slot >= 0).numpy()
    assert hit.mean() > 0.3
    js = jax_build_pt_scene(triangles=tris, tri_mats=np.zeros(len(tris), np.int32),
                            tri_uvs=uvs, materials=[{"albedo": (0.5, 0.5, 0.5),
                                                     "normal": np.full((2, 2, 3), 0.5,
                                                                       np.float32)}])
    assert js.needs_tan
    jt, jidx, _, _, _, jtan = jwave._tri_hits(js, tuple(jnp.asarray(x) for x in _rays()[0]),
                                              tuple(jnp.asarray(x) for x in _rays()[1]), 1e-3,
                                              jcs)
    jt, jidx = np.asarray(jt), np.asarray(jidx)
    np.testing.assert_array_equal(hit, jt < jwave.BIG)
    tri = cs.perm[slot.clamp_min(0).long()].numpy()
    same = hit & (tri == jidx)
    assert same.sum() >= 0.99 * hit.sum()
    np.testing.assert_allclose(got[0].numpy()[same], jt[same], rtol=1e-6, atol=0.0)
    for a in range(3):
        np.testing.assert_allclose(got[9 + a].numpy()[same], np.asarray(jtan[a])[same],
                                   atol=1e-6, rtol=0.0)
        assert np.all(got[9 + a].numpy()[~hit] == 0.0)
    assert np.abs(np.stack([x.numpy() for x in got[9:]])).max() > 0.1
    _, idx, _, _, _, gtan = wavefront._tri_hits_clusters(o, d, 1e-3, cs, need_tan=True)
    same = torch.from_numpy(hit) & (torch.from_numpy(tri).long() == idx)
    assert same.sum() >= 0.99 * hit.sum()  # its own visit orders may break a tie otherwise
    for a in range(3):
        assert torch.equal(got[9 + a][same], gtan[a][same])
    flat = clusters.build_clusters(tris, device=CPU)
    assert len(cluster.cluster_intersect(flat, o, d, float("inf"), attrs=True, tan=True)) == 7


def _struct_fields(src, name):
    import re

    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"(\w+)\s*[,;]", body)


def test_cluster_args_mirror_the_cuda_structs():
    cuh = (common.CSRC_DIR / "cluster.cuh").read_text()
    cu = (common.CSRC_DIR / "cluster.cu").read_text()
    assert _struct_fields(cuh, "Tables") == [f for f, _ in cluster.ClusterTables._fields_]
    assert _struct_fields(cu, "Args") == [f for f, _ in cluster.ClusterArgs._fields_]


# --- the batched selection against a sequential scan ------------------------

def _slab_np(b, o, inv, t_min, t):
    f = np.float32
    tx0, tx1 = (f(b[0]) - o[0]) * inv[0], (f(b[3]) - o[0]) * inv[0]
    ty0, ty1 = (f(b[1]) - o[1]) * inv[1], (f(b[4]) - o[1]) * inv[1]
    tz0, tz1 = (f(b[2]) - o[2]) * inv[2], (f(b[5]) - o[2]) * inv[2]
    mn, mx = np.fmin, np.fmax  # NaN handled below
    if np.isnan([tx0, tx1, ty0, ty1, tz0, tz1]).any():
        return False
    t_near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mn(tz0, tz1))
    t_far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
    return bool(t_near <= t_far and t_far > t_min and t_near < t)


def _scan_one(tb, order, o, d, t, t_min, any_hit):
    """One ray, every gate and test in sequence (csrc/cluster.cuh sweep)."""
    f = np.float32
    inv = f(1.0) / d
    idx, u_hit, v_hit = -1, f(0), f(0)
    sbox, crec, trec = tb.sbox.numpy(), tb.crec.numpy(), tb.trec.numpy()
    for s in order:
        if not _slab_np(sbox[s], o, inv, t_min, t):
            continue
        for k in range(8):
            c = s * 8 + k
            if not _slab_np(crec[c, :6], o, inv, t_min, t):
                continue
            lo = o - crec[c, 8:11]
            for sub in range(4):
                if not _slab_np(crec[c, 12 + 6 * sub:18 + 6 * sub], o, inv, t_min, t):
                    continue
                for j in range(32):
                    r = trec[c * 128 + sub * 32 + j]
                    den = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
                    num = r[0] * lo[0] + r[1] * lo[1] + r[2] * lo[2] + r[3]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        tt = -num * (f(1.0) / den)
                    p = lo + tt * d
                    u = r[4] * p[0] + r[5] * p[1] + r[6] * p[2] + r[7]
                    v = r[8] * p[0] + r[9] * p[1] + r[10] * p[2] + r[11]
                    if u >= 0 and v >= 0 and u + v <= 1 and tt > t_min and tt < t:
                        t, idx, u_hit, v_hit = tt, c * 128 + sub * 32 + j, u, v
            if any_hit and idx >= 0:
                return t, idx
    return t, idx


@pytest.mark.parametrize("any_hit", [False, True])
def test_batched_selection_equals_sequential_scan(any_hit):
    """Every triangle twice: each hit is an exact tie, and the first one
    the ray's own order visits must win."""
    tris = mesh.icosphere(1, radius=1.2, center=tuple(CENTER))
    cs = clusters.build_clusters(np.concatenate([tris, tris]), device=CPU)
    tb = cluster.sweep_tables(cs)
    fc = cluster.FrameClusters.at(cs, torch.from_numpy(CENTER + 3.0))
    o, d = _rays(2)
    o, d = o[:, :8, :4].reshape(3, -1), d[:, :8, :4].reshape(3, -1)
    t_max = np.float32(T_MAX_ANY if any_hit else np.inf)
    kw = dict(any_hit=any_hit, order=fc.orders[0])
    if not any_hit:
        kw.update(orders=fc.orders, refs=fc.refs)
    t, idx = cluster.cluster_intersect(cs, tuple(torch.from_numpy(x) for x in o),
                                       tuple(torch.from_numpy(x) for x in d), float(t_max), **kw)
    rows = cluster._ray_rows(tuple(torch.from_numpy(x) for x in o), fc.refs).numpy()
    for i in range(o.shape[1]):
        order = fc.orders[0 if any_hit else rows[i]].numpy()
        want_t, want_i = _scan_one(tb, order, o[:, i], d[:, i], t_max, np.float32(1e-3), any_hit)
        assert int(idx[i]) == want_i, i
        assert float(t[i]) == (float(want_t) if want_i >= 0 else float("inf")), i
    assert (idx >= 0).sum() > 10
