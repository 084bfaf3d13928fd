"""Stackless threaded BVH, host-built (raytracing_engine_tpu/accel/bvh.py).

Layout: nodes flattened in DFS preorder. An interior node's "hit" successor
is implicitly ``node+1`` (its left child); every node stores a ``skip`` link
— the preorder index of the next subtree — taken on a miss (or after a leaf).

Build: ``method="sah"`` (default) is a 16-bin binned surface-area-heuristic
split; ``method="median"`` (longest-centroid-axis median split) is kept as
the reference partitioner. The native C++ builder (native/) produces the
same arrays faster for big meshes; the numpy implementation here is the
reference and the fallback. Both are copies of the JAX package's and equal
its arrays (tests/test_torch_accel.py).

Traversal: ``bvh_intersect`` is the plain PyTorch skip-link traversal of
the JAX package (closest or any hit, a per-ray step cap). It is the CPU
path of the wavefront's raw-BVH branch and, through ``traverse``, the
plain version of kernel K8 (ops/cuda/bvh_traverse.py), which equals it bit
for bit. ``accel/clusters.py`` consumes the BVH's leaf order.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from raytracing_engine_tpu_torch.device import resolve

LEAF_SIZE = 4
SAH_BINS = 16


@dataclasses.dataclass
class BVH:
    # nodes, DFS preorder
    bb_min: torch.Tensor     # (N, 3) f32
    bb_max: torch.Tensor     # (N, 3) f32
    first_tri: torch.Tensor  # (N,) int32 — start into reordered tris; -1 = interior
    tri_count: torch.Tensor  # (N,) int32 — 0 for interior
    skip: torch.Tensor       # (N,) int32 — next preorder subtree (miss link)
    # reordered triangle SoA (gathered once at build)
    v0: torch.Tensor         # (T, 3)
    e1: torch.Tensor         # (T, 3)
    e2: torch.Tensor         # (T, 3)
    perm: torch.Tensor       # (T,) int32 — reordered index -> original tri index
    builder: str = "numpy"   # which builder made it: "native" or "numpy"

    @property
    def device(self) -> torch.device:
        return self.bb_min.device

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "BVH":
        return dataclasses.replace(self, **{k: v.to(device) for k, v in self.tensors().items()})


def build_bvh_arrays(triangles: np.ndarray, leaf_size: int = LEAF_SIZE,
                     use_native: bool | None = None, method: str = "sah"):
    """The BVH as numpy arrays by field name, and the builder that made it
    ("native" or "numpy"). use_native: True = require the C++ builder,
    False = the numpy reference, None = native if it builds."""
    if method not in ("sah", "median"):
        raise ValueError(f"method must be 'sah' or 'median': {method!r}")
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    T = tris.shape[0]

    if use_native is not False:
        from raytracing_engine_tpu_torch.native.loader import get_bvh_lib

        lib = get_bvh_lib()
        if lib is not None:
            cap = 4 * max(T // max(leaf_size // 2, 1), 1) + 8
            bbmin = np.empty((cap, 3), np.float32)
            bbmax = np.empty((cap, 3), np.float32)
            first = np.empty((cap,), np.int32)
            cnt = np.empty((cap,), np.int32)
            skp = np.empty((cap,), np.int32)
            perm = np.empty((T,), np.int32)
            n = lib.bvh_build(tris.reshape(T, 9), T, leaf_size, cap,
                              bbmin, bbmax, first, cnt, skp, perm,
                              1 if method == "sah" else 0)
            if n > 0:
                return _arrays(tris, bbmin[:n], bbmax[:n], first[:n], cnt[:n],
                               skp[:n], perm), "native"
        if use_native:
            raise RuntimeError("native BVH builder unavailable")
    lo = tris.min(axis=1)  # (T, 3)
    hi = tris.max(axis=1)
    centroid = (lo + hi) * 0.5

    order = np.arange(T)
    bb_min, bb_max, first, count, skip = [], [], [], [], []
    out_order = []

    # iterative DFS preorder build; each frame = (index slice, parent patch)
    def emit(node):
        bb_min.append(node[0])
        bb_max.append(node[1])
        first.append(node[2])
        count.append(node[3])
        skip.append(-1)  # patched after subtree is emitted
        return len(bb_min) - 1

    def split_median(ids, c, axis):
        med = len(ids) // 2
        part = np.argpartition(c[:, axis], med)
        return ids[part[:med]], ids[part[med:]]

    def split_sah(ids, c, axis, clo, chi):
        """16-bin binned SAH on the longest centroid axis: min over split
        planes of A_left*N_left + A_right*N_right. Falls back to median when
        the centroids are degenerate or every candidate plane leaves one
        side empty."""
        ext = chi[axis] - clo[axis]
        if not ext > 0:
            return split_median(ids, c, axis)
        b = np.minimum((
            (c[:, axis] - clo[axis]) * (SAH_BINS / ext)).astype(np.int64),
            SAH_BINS - 1)
        cnt_b = np.bincount(b, minlength=SAH_BINS)
        binlo = np.full((SAH_BINS, 3), 1e30, np.float32)
        binhi = np.full((SAH_BINS, 3), -1e30, np.float32)
        np.minimum.at(binlo, b, lo[ids])
        np.maximum.at(binhi, b, hi[ids])

        def areas(lo_c, hi_c):
            d = np.maximum(hi_c - lo_c, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # growing unions left-to-right and right-to-left
        llo = np.minimum.accumulate(binlo, 0)
        lhi = np.maximum.accumulate(binhi, 0)
        rlo = np.minimum.accumulate(binlo[::-1], 0)[::-1]
        rhi = np.maximum.accumulate(binhi[::-1], 0)[::-1]
        nl = np.cumsum(cnt_b)[:-1]             # split after bin i: bins <= i left
        nr = len(ids) - nl
        cost = (areas(llo, lhi)[:-1] * nl + areas(rlo, rhi)[1:] * nr)
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            return split_median(ids, c, axis)
        mask = b <= best
        return ids[mask], ids[~mask]

    def build(ids):
        n0 = emit((lo[ids].min(0), hi[ids].max(0), -1, 0))
        if len(ids) <= leaf_size:
            bb = len(out_order)
            first[n0] = bb
            count[n0] = len(ids)
            out_order.extend(ids.tolist())
        else:
            c = centroid[ids]
            clo, chi = c.min(0), c.max(0)
            axis = int(np.argmax(chi - clo))
            if method == "sah":
                left, right = split_sah(ids, c, axis, clo, chi)
            else:
                left, right = split_median(ids, c, axis)
            build(left)
            build(right)
        skip[n0] = len(bb_min)  # next preorder index after this subtree
        return n0

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(order)
    finally:
        sys.setrecursionlimit(old_limit)

    perm = np.asarray(out_order, np.int32)
    return _arrays(tris, np.stack(bb_min), np.stack(bb_max), np.asarray(first, np.int32),
                   np.asarray(count, np.int32), np.asarray(skip, np.int32), perm), "numpy"


def _arrays(tris, bb_min, bb_max, first, count, skip, perm) -> dict:
    rt = tris[perm]
    return dict(bb_min=np.asarray(bb_min, np.float32), bb_max=np.asarray(bb_max, np.float32),
                first_tri=first, tri_count=count, skip=skip,
                v0=rt[:, 0], e1=rt[:, 1] - rt[:, 0], e2=rt[:, 2] - rt[:, 0], perm=perm)


def build_bvh(triangles: np.ndarray, leaf_size: int = LEAF_SIZE,
              use_native: bool | None = None, method: str = "sah",
              device=None) -> BVH:
    """triangles: (T, 3, 3) float32 vertex array -> BVH on `device` (None:
    the CUDA card). use_native and method as in build_bvh_arrays; the BVH's
    ``builder`` says which builder ran."""
    arrays, builder = build_bvh_arrays(triangles, leaf_size, use_native, method)
    device = resolve(device)
    return BVH(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in arrays.items()}, builder=builder)


def traverse(bb_min, bb_max, first, count, skip, v0, e1, e2, o, d, t0, t_min: float,
             any_hit: bool, max_steps: int, work: dict | None = None):
    """The skip-link traversal of flat (n,) ray planes o, d (3-tuples) from
    initial t0 (n,): (t, idx int64, u, v), t = +inf and idx = -1 on a miss.

    Per ray, exactly JAX ``bvh_intersect``'s walk (accel/bvh.py:201-285): at
    most max_steps nodes in preorder; a node whose box passes the gate
    (t_near <= t_far, t_far > t_min, t_near < t) descends to node+1, or, at
    a leaf, runs its <= LEAF_SIZE Möller-Trumbore tests in order with the
    strict ``tt < t`` update; any other node takes its skip link. any_hit
    stops a ray after the leaf of its first hit. Rays that have left the
    tree drop out of the batch, so each step costs its live rays only.
    ``work`` (optional) counts the node tests ("nodes") and triangle tests
    ("tests") made, for kernel K8's bound."""
    dev = o[0].device
    n = o[0].numel()
    n_nodes, n_tris = bb_min.shape[0], v0.shape[0]
    inv = tuple(torch.reciprocal(c) for c in d)
    t = t0.clone()
    idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev) if n_nodes > 0 else torch.zeros(0, dtype=torch.int64,
                                                                       device=dev)
    first, count, skip = first.to(torch.int64), count.to(torch.int64), skip.to(torch.int64)
    steps = 0
    while act.numel() > 0 and steps < max_steps:
        nd = node[act]
        oa = tuple(c[act] for c in o)
        ia = tuple(c[act] for c in inv)
        lo, hi = bb_min[nd], bb_max[nd]
        tx0 = (lo[:, 0] - oa[0]) * ia[0]
        tx1 = (hi[:, 0] - oa[0]) * ia[0]
        ty0 = (lo[:, 1] - oa[1]) * ia[1]
        ty1 = (hi[:, 1] - oa[1]) * ia[1]
        tz0 = (lo[:, 2] - oa[2]) * ia[2]
        tz1 = (hi[:, 2] - oa[2]) * ia[2]
        t_near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
        t_far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                              torch.maximum(tz0, tz1))
        box_hit = (t_near <= t_far) & (t_far > t_min) & (t_near < t[act])
        f, cnt = first[nd], count[nd]
        leaf = f >= 0
        rows = torch.nonzero(box_hit & leaf).squeeze(1)
        if work is not None:
            work["nodes"] += act.numel()
            work["tests"] += int(cnt[rows].clamp(0, LEAF_SIZE).sum())
        if rows.numel() > 0:
            al, fl, cl = act[rows], f[rows], cnt[rows]
            ox, oy, oz = (c[al] for c in o)
            dx, dy, dz = (c[al] for c in d)
            tl, il, ul, vl = t[al], idx[al], u[al], v[al]
            for k in range(LEAF_SIZE):
                ti = torch.clamp(fl + k, 0, n_tris - 1)
                a, b, c = v0[ti], e1[ti], e2[ti]
                px = dy * c[:, 2] - dz * c[:, 1]  # pvec = d x e2
                py = dz * c[:, 0] - dx * c[:, 2]
                pz = dx * c[:, 1] - dy * c[:, 0]
                det = b[:, 0] * px + b[:, 1] * py + b[:, 2] * pz
                inv_det = 1.0 / torch.where(torch.abs(det) < 1e-9, 1.0, det)
                tvx, tvy, tvz = ox - a[:, 0], oy - a[:, 1], oz - a[:, 2]
                uu = (tvx * px + tvy * py + tvz * pz) * inv_det
                qx = tvy * b[:, 2] - tvz * b[:, 1]  # qvec = tvec x e1
                qy = tvz * b[:, 0] - tvx * b[:, 2]
                qz = tvx * b[:, 1] - tvy * b[:, 0]
                vv = (dx * qx + dy * qy + dz * qz) * inv_det
                tt = (c[:, 0] * qx + c[:, 1] * qy + c[:, 2] * qz) * inv_det
                ok = ((k < cl) & (torch.abs(det) >= 1e-9) & (uu >= 0.0) & (vv >= 0.0)
                      & (uu + vv <= 1.0) & (tt > t_min) & (tt < tl))
                tl = torch.where(ok, tt, tl)
                il = torch.where(ok, ti, il)
                ul = torch.where(ok, uu, ul)
                vl = torch.where(ok, vv, vl)
            t[al], idx[al], u[al], v[al] = tl, il, ul, vl
        nxt = torch.where(box_hit & ~leaf, nd + 1, skip[nd])
        if any_hit:
            nxt = torch.where(idx[act] >= 0, n_nodes, nxt)  # a confirmed hit ends the walk
        node[act] = nxt
        act = act[nxt < n_nodes]
        steps += 1
    return torch.where(idx >= 0, t, float("inf")), idx, u, v


def bvh_intersect(bvh: BVH, o3, d3, t_min=1e-3, t_max=float("inf"), any_hit: bool = False,
                  max_steps: int = 10_000):
    """Closest-hit (or, with any_hit, first-hit) traversal of a batch of
    rays: o3/d3 (..., 3). Returns (t, tri_idx int32, u, v) of the batch's
    shape: t = +inf and tri_idx = -1 on a miss; tri_idx indexes the
    REORDERED arrays (bvh.perm maps it back). t_max: a scalar or a per-ray
    cutoff (shadow rays). JAX accel.bvh.bvh_intersect, in PyTorch."""
    batch = tuple(o3.shape[:-1])
    o = tuple(o3[..., a].reshape(-1).to(torch.float32) for a in range(3))
    d = tuple(d3[..., a].reshape(-1).to(torch.float32) for a in range(3))
    t0 = torch.as_tensor(t_max, dtype=torch.float32, device=o[0].device)
    t0 = t0.expand(batch).reshape(-1).contiguous()
    t, idx, u, v = traverse(bvh.bb_min, bvh.bb_max, bvh.first_tri, bvh.tri_count, bvh.skip,
                            bvh.v0, bvh.e1, bvh.e2, o, d, t0, float(t_min), any_hit, max_steps)
    return (t.reshape(batch), idx.to(torch.int32).reshape(batch), u.reshape(batch),
            v.reshape(batch))
