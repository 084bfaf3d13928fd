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

The traversal ``bvh_intersect`` and its kernel K8 are not in this slice
(ROADMAP queue 1 item 3, the next slice); ``accel/clusters.py`` consumes
the BVH's leaf order.
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
