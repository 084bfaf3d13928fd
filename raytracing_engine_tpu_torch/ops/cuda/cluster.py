"""K6: the cluster intersector through the CUDA kernel ``cluster_kernel``
(csrc/cluster.cu, sweep in csrc/cluster.cuh), which replaces
raytracing_engine_tpu/ops/pallas/cluster_intersect.py ``_cluster_kernel``.

``cluster_intersect`` keeps the JAX signature and results: t (+inf on a
miss) and the padded-reordered slot (-1 on a miss; ``cs.perm`` maps it back),
plus (nx, ny, nz, mat, area) with ``attrs=True``, and on a UV table
(``cs.has_uv``, rows 32-37) the hit's interpolated texture (u, v) after
them, and with ``tan=True`` the triangle's world texture-u tangent (tx, ty,
tz) = du1 r1 + du2 r2 after those (the barycentric gradient rows r1, r2
times the UV deltas; normal maps and mip LOD read it). Rays on the CPU take the
plain version, ``cluster_intersect_reference``; rays on a CUDA device launch
the kernel or raise.

Visit order: the TPU sweep picks one order per tile (the reference nearest
the tile's mean live origin). Here every closest-hit ray picks its own row
of ``orders``, the one whose reference is nearest its origin, and the plain
version replays exactly that order, so kernel and plain version agree bit
for bit. Any-hit sweeps use ``order``. Results do not depend on the order
except where two triangles meet the ray at exactly the same t (the first one
visited wins).

``sweep_tables`` transposes a ClusterSet's (ROWS, T_pad) lane table once
into the per-triangle and per-cluster records the kernel reads
(csrc/cluster.cuh), and a UV table's rows 32-37 into an 8-float record per
slot; the plain version reads the same records. ``work``
counts the box and triangle tests the plain version performed, for the
kernels' bounds (utils/timing.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.clusters import (
    CLUSTER,
    SUBS,
    SUPER,
    ClusterSet,
    visit_orders,
)
from raytracing_engine_tpu_torch.ops.cuda import common

SUB_TRIS = CLUSTER // SUBS
PARKED = 1e17
_INF = float("inf")

# kernel launches since the count was last set to 0 (plain-version calls
# do not count), and those of them with the tangent planes
launches = 0
tan_launches = 0
# tests the plain version performed since they were last set to 0: box slab
# tests (super, cluster and sub boxes) and Baldwin–Weber triangle tests
work = {"slabs": 0, "tests": 0}


class ClusterTables(ctypes.Structure):
    """Mirror of ``cl::Tables`` (csrc/cluster.cuh), field for field."""

    _fields_ = [
        ("sbox", ctypes.c_void_p),
        ("crec", ctypes.c_void_p),
        ("trec", ctypes.c_void_p),
        ("tsmooth", ctypes.c_void_p),
        ("order", ctypes.c_void_p),
        ("orders", ctypes.c_void_p),
        ("refs", ctypes.c_void_p),
        ("n_super", ctypes.c_int),
        ("n_orders", ctypes.c_int),
    ]


class ClusterArgs(ctypes.Structure):
    """Mirror of ``cl::Args`` (csrc/cluster.cu), field for field."""

    _fields_ = [
        ("tables", ClusterTables),
        ("ox", ctypes.c_void_p),
        ("oy", ctypes.c_void_p),
        ("oz", ctypes.c_void_p),
        ("dx", ctypes.c_void_p),
        ("dy", ctypes.c_void_p),
        ("dz", ctypes.c_void_p),
        ("tmax", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("out_idx", ctypes.c_void_p),
        ("out_attr", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("t_min", ctypes.c_float),
        ("any_hit", ctypes.c_int),
        ("device", ctypes.c_int),
        ("tuv", ctypes.c_void_p),
        ("tan", ctypes.c_int),
    ]


@dataclasses.dataclass
class SweepTables:
    """A ClusterSet as the kernel reads it (see csrc/cluster.cuh)."""

    sbox: torch.Tensor     # (S, 8) super boxes
    crec: torch.Tensor     # (C, 36) [box(6), 0, 0, oc(3), 0, sub-boxes 4 x 6]
    trec: torch.Tensor     # (T_pad, 16) [n, nd, r1, c1, r2, c2, mat, |n|, 0, 0]
    tsmooth: torch.Tensor | None  # (T_pad, 12) [s0, s1-s0, s2-s0, 0 x3] or None
    tuv: torch.Tensor | None = None  # (T_pad, 8) [uv0, uv1-uv0, uv2-uv0, 0 x2] or None

    @property
    def n_super(self) -> int:
        return self.sbox.shape[0]


def sweep_tables(cs: ClusterSet) -> SweepTables:
    """The kernel's records of `cs`, built once on its device (cached on the
    ClusterSet; torch ops only, no host round trip)."""
    cached = cs.__dict__.get("_sweep_tables")
    if cached is not None:
        return cached
    f32, dev = torch.float32, cs.device
    T_pad, C = cs.padded_tris, cs.num_clusters
    trec = torch.cat([cs.tri[0:14].T, torch.zeros((T_pad, 2), dtype=f32, device=dev)], 1)
    tsmooth = None
    if cs.smooth:
        tsmooth = torch.cat([cs.tri[21:30].T, torch.zeros((T_pad, 3), dtype=f32, device=dev)], 1)
    tuv = None
    if cs.has_uv:
        tuv = torch.cat([cs.tri[32:38].T, torch.zeros((T_pad, 2), dtype=f32, device=dev)], 1)
    sub = cs.tri[14:20].reshape(6, C, CLUSTER)[:, :, :SUBS].permute(1, 2, 0).reshape(C, 6 * SUBS)
    oc = cs.tri[20].reshape(C, CLUSTER)[:, :3]
    z = lambda k: torch.zeros((C, k), dtype=f32, device=dev)  # noqa: E731
    crec = torch.cat([cs.boxes[:, :6], z(2), oc, z(1), sub], 1)
    tables = SweepTables(sbox=cs.super_boxes.contiguous(), crec=crec.contiguous(),
                         trec=trec.contiguous(),
                         tsmooth=None if tsmooth is None else tsmooth.contiguous(),
                         tuv=None if tuv is None else tuv.contiguous())
    cs.__dict__["_sweep_tables"] = tables
    return tables


@dataclasses.dataclass
class FrameClusters:
    """A ClusterSet with one frame's visit orders: row 0 of ``orders`` is
    the near-to-far order from the camera (every any-hit sweep uses it),
    rows 1+ those from the set's order_refs. The path tracer's kernels take
    this view and the attributes path of the plain wavefront follows it
    (the JAX megakernel's KernelClusters, pt_kernel.py:620-645)."""

    cs: ClusterSet
    orders: torch.Tensor  # (K, S) int32
    refs: torch.Tensor    # (K, 3) f32

    @classmethod
    def at(cls, cs: ClusterSet, origin) -> "FrameClusters":
        """Orders for a frame seen from `origin` (3,) (on cs's device)."""
        refs = origin.to(torch.float32).reshape(1, 3)
        if cs.order_refs is not None and cs.order_refs.shape[0] > 0:
            refs = torch.cat([refs, cs.order_refs], 0)
        refs = refs.contiguous()
        return cls(cs=cs, orders=visit_orders(cs, refs).contiguous(), refs=refs)


def _slab_gate(box, o, inv, t_min, t):
    """cluster_intersect._slab_vals and the sweep's gate; box (n, 6)."""
    tx0 = (box[:, 0] - o[0]) * inv[0]
    tx1 = (box[:, 3] - o[0]) * inv[0]
    ty0 = (box[:, 1] - o[1]) * inv[1]
    ty1 = (box[:, 4] - o[1]) * inv[1]
    tz0 = (box[:, 2] - o[2]) * inv[2]
    tz1 = (box[:, 5] - o[2]) * inv[2]
    t_near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
    t_far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                          torch.maximum(tz0, tz1))
    return (t_near <= t_far) & (t_far > t_min) & (t_near < t)


def _ray_rows(o, refs):
    """Per ray, the index of the reference nearest its origin (first on a
    tie): csrc/cluster.cuh ray_order."""
    best = torch.full_like(o[0], _INF)
    row = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    for k in range(refs.shape[0]):
        ddx = refs[k, 0] - o[0]
        ddy = refs[k, 1] - o[1]
        ddz = refs[k, 2] - o[2]
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        sel = d2 < best
        best = torch.where(sel, d2, best)
        row = torch.where(sel, k, row)
    return row


def _sweep(tb: SweepTables, o, d, t0, t_min: float, any_hit: bool, order, orders, refs):
    """The plain sweep over flat (n,) planes: (t, idx int64, u, v), t = t0
    where idx < 0. Rays advance together through each ray's own visit order;
    at every level only the rays that pass the gate go on, and a sub-box's
    32 tests run as one batch: the sequential strict `tt < t` scan keeps the
    first triangle of the smallest t, which is what the batch selects."""
    dev = o[0].device
    n = o[0].numel()
    t = t0.clone()
    idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    inv = tuple(torch.reciprocal(c) for c in d)
    act = torch.arange(n, device=dev)
    if any_hit or orders is None or refs is None or orders.shape[0] == 0:
        table, row = order.to(torch.int64)[None, :], torch.zeros_like(act)
    else:
        table, row = orders.to(torch.int64), _ray_rows(o, refs)
    if any_hit:
        idx = torch.where(o[0].abs() >= PARKED, 0, idx)
    lane = torch.arange(SUB_TRIS, device=dev)
    for si in range(tb.n_super):
        if any_hit:
            act = act[idx[act] < 0]
        if act.numel() == 0:
            break
        work["slabs"] += act.numel()
        s = table[row[act], si]
        oa = tuple(c[act] for c in o)
        g = _slab_gate(tb.sbox[s], oa, tuple(c[act] for c in inv), t_min, t[act])
        a1, s1 = act[g], s[g]
        for k in range(SUPER):
            if any_hit:
                keep = idx[a1] < 0
                a1, s1 = a1[keep], s1[keep]
            if a1.numel() == 0:
                break
            work["slabs"] += a1.numel()
            c = s1 * SUPER + k
            rec = tb.crec[c]
            o1, i1 = tuple(x[a1] for x in o), tuple(x[a1] for x in inv)
            g = _slab_gate(rec[:, 0:6], o1, i1, t_min, t[a1])
            a2, c2, rec = a1[g], c[g], rec[g]
            if a2.numel() == 0:
                continue
            o2, i2, d2 = tuple(x[a2] for x in o), tuple(x[a2] for x in inv), tuple(x[a2] for x in d)
            lo = tuple(o2[a] - rec[:, 8 + a] for a in range(3))
            for sub in range(SUBS):
                work["slabs"] += a2.numel()
                box = rec[:, 12 + 6 * sub:18 + 6 * sub]
                g = _slab_gate(box, o2, i2, t_min, t[a2])
                a3 = a2[g]
                if a3.numel() == 0:
                    continue
                work["tests"] += SUB_TRIS * a3.numel()
                base = c2[g] * CLUSTER + sub * SUB_TRIS
                tri = tb.trec[base[:, None] + lane]  # (n3, 32, 16)
                dx, dy, dz = (x[g][:, None] for x in d2)
                lx, ly, lz = (x[g][:, None] for x in lo)
                den = tri[..., 0] * dx + tri[..., 1] * dy + tri[..., 2] * dz
                num = tri[..., 0] * lx + tri[..., 1] * ly + tri[..., 2] * lz + tri[..., 3]
                tt = -num * torch.reciprocal(den)
                px = lx + tt * dx
                py = ly + tt * dy
                pz = lz + tt * dz
                uu = tri[..., 4] * px + tri[..., 5] * py + tri[..., 6] * pz + tri[..., 7]
                vv = tri[..., 8] * px + tri[..., 9] * py + tri[..., 10] * pz + tri[..., 11]
                ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > t_min)
                      & (tt < t[a3][:, None]))
                ttm = torch.where(ok, tt, _INF)
                best = ttm.amin(dim=1)
                first = torch.where(ttm == best[:, None], lane, SUB_TRIS).amin(dim=1)
                hit = best < _INF
                if not bool(hit.any()):
                    continue
                ah, jh = a3[hit], first[hit]
                t[ah] = best[hit]
                idx[ah] = base[hit] + jh
                rows = torch.nonzero(hit).squeeze(1)
                u[ah] = uu[rows, jh]
                v[ah] = vv[rows, jh]
    return t, idx, u, v


def _attrs(tb: SweepTables, idx, u, v, tan: bool = False):
    """(nx, ny, nz, mat, area) of each hit, and (u, v) of its texture
    coordinates on a UV table, then with tan its texture-u tangent du1 r1 +
    du2 r2; 0 where idx < 0 (cluster.cuh hit_attrs / hit_uv / hit_tan and
    the kernel's output)."""
    safe = idx.clamp_min(0)
    rec = tb.trec[safe]
    if tb.tsmooth is not None:
        sm = tb.tsmooth[safe]
        n = tuple(sm[:, a] + u * sm[:, 3 + a] + v * sm[:, 6 + a] for a in range(3))
    else:
        n = (rec[:, 0], rec[:, 1], rec[:, 2])
    cols = (*n, rec[:, 12], rec[:, 13])
    if tb.tuv is not None:  # cluster_intersect.py:290-295
        uv = tb.tuv[safe]
        cols += tuple(uv[:, a] + u * uv[:, 2 + a] + v * uv[:, 4 + a] for a in range(2))
        if tan:  # cluster_intersect.py:297-313
            cols += tuple(uv[:, 2] * rec[:, 4 + a] + uv[:, 4] * rec[:, 8 + a] for a in range(3))
    hit = idx >= 0
    zero = torch.zeros((), dtype=torch.float32, device=idx.device)
    out = tuple(torch.where(hit, x, zero) for x in cols)
    return out[:4] + (out[4] * 0.5,) + out[5:]


def _flat_inputs(cs, o_planes, d_planes, t_max, order):
    shape, o, d, t0 = common.flat_rays(o_planes, d_planes, t_max)
    if order is None:
        order = torch.arange(cs.num_super, dtype=torch.int32, device=cs.device)
    return shape, o, d, t0, order


def cluster_intersect_reference(cs: ClusterSet, o_planes, d_planes, t_max, t_min=1e-3,
                                any_hit=False, attrs=False, order=None, orders=None, refs=None,
                                tan=False):
    """Plain PyTorch version of cluster_intersect (same arguments and
    results); it counts its tests in ``work``."""
    shape, o, d, t0, order = _flat_inputs(cs, o_planes, d_planes, t_max, order)
    tb = sweep_tables(cs)
    refs = None if refs is None else refs[:, :3]
    t, idx, u, v = _sweep(tb, o, d, t0, float(t_min), any_hit, order, orders, refs)
    out_t = torch.where(idx >= 0, t, _INF).reshape(shape)
    out_idx = idx.to(torch.int32).reshape(shape)
    if not attrs:
        return out_t, out_idx
    return (out_t, out_idx) + tuple(a.reshape(shape) for a in _attrs(tb, idx, u, v, tan))


def tables_struct(tb: SweepTables, order, orders=None, refs=None) -> ClusterTables:
    """cl::Tables of `tb` and the visit orders (tensors kept alive by the
    caller until the launch has been enqueued)."""
    return ClusterTables(
        sbox=tb.sbox.data_ptr(), crec=tb.crec.data_ptr(), trec=tb.trec.data_ptr(),
        tsmooth=0 if tb.tsmooth is None else tb.tsmooth.data_ptr(),
        order=order.data_ptr(),
        orders=0 if orders is None else orders.data_ptr(),
        refs=0 if refs is None else refs.data_ptr(),
        n_super=tb.n_super, n_orders=0 if orders is None else orders.shape[0])


def check_orders(cs: ClusterSet, order, orders, refs):
    """Validate the visit orders handed to a kernel; -> (order, orders, refs)
    as contiguous int32 / f32 tensors on cs's device (refs (K, 3))."""
    dev, S = cs.device, cs.num_super
    common.check(order, "order", (S,), torch.int32, dev)
    if orders is None:
        return order, None, None
    if refs is None:
        raise ValueError("orders needs refs, its reference origins")
    refs = refs[:, :3].contiguous()
    common.check(orders, "orders", (orders.shape[0], S), torch.int32, dev)
    common.check(refs, "refs", (orders.shape[0], 3), torch.float32, dev)
    return order, orders, refs


def cluster_intersect(cs: ClusterSet, o_planes, d_planes, t_max, t_min=1e-3, any_hit=False,
                      attrs=False, order=None, orders=None, refs=None, tan=False):
    """Intersect a grid of rays (planes of any shape) with a ClusterSet:
    (t, idx int32) — t = +inf and idx = -1 on a miss; idx is the
    padded-reordered slot (cs.perm maps it to the original triangle).
    attrs=True appends (nx, ny, nz, mat, area): the unnormalized geometric
    normal (interpolated shading normal on smooth tables), the material id
    (f32, tri row 12) and the triangle area of the hit. t_max: a scalar or a
    plane, the initial t (the any-hit cutoff). order: (S,) int32 visit order
    (default 0..S-1); orders/refs: (K, S) int32 orders and their (K, 3|4)
    reference origins, from which each closest-hit ray takes the row
    nearest its origin. On a UV table attrs=True appends (u, v), the hit's
    texture coordinates (0 on a miss), and with tan=True then (tx, ty, tz),
    its world texture-u tangent (0 on a miss); tan is ignored on a table
    without UVs, as in the JAX package."""
    global launches, tan_launches
    if o_planes[0].device.type == "cpu":
        return cluster_intersect_reference(cs, o_planes, d_planes, t_max, t_min, any_hit,
                                           attrs=attrs, order=order, orders=orders, refs=refs,
                                           tan=tan)
    dev = cs.device
    if dev.type != "cuda" or o_planes[0].device != dev:
        raise ValueError(f"rays on {o_planes[0].device}, ClusterSet on {dev}: the CUDA "
                         "kernel needs both on one CUDA device")
    shape, o, d, t0, order = _flat_inputs(cs, o_planes, d_planes, t_max, order)
    if any_hit:
        orders = refs = None
    order, orders, refs = check_orders(cs, order, orders, refs)
    tb = sweep_tables(cs)
    n = t0.numel()
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    tan = bool(tan and tb.tuv is not None and attrs)
    n_attr = (10 if tan else 7) if tb.tuv is not None else 5
    out_attr = torch.empty((n_attr, n), dtype=torch.float32, device=dev) if attrs else None
    args = ClusterArgs(
        tables=tables_struct(tb, order, orders, refs),
        ox=o[0].data_ptr(), oy=o[1].data_ptr(), oz=o[2].data_ptr(),
        dx=d[0].data_ptr(), dy=d[1].data_ptr(), dz=d[2].data_ptr(), tmax=t0.data_ptr(),
        out_t=out_t.data_ptr(), out_idx=out_idx.data_ptr(),
        out_attr=0 if out_attr is None else out_attr.data_ptr(),
        n=n, t_min=float(np.float32(t_min)), any_hit=int(any_hit),
        device=dev.index if dev.index is not None else torch.cuda.current_device(),
        tuv=0 if tb.tuv is None else tb.tuv.data_ptr(), tan=int(tan))
    common.launch("cluster_intersect", args, name="cluster")
    launches += 1
    tan_launches += int(tan)
    out = (out_t.reshape(shape), out_idx.reshape(shape))
    if attrs:
        out += tuple(out_attr[a].reshape(shape) for a in range(n_attr))
    return out
