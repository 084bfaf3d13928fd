"""Cluster-binned triangle layout (raytracing_engine_tpu/accel/clusters.py).

The BVH's spatially coherent leaf order is cut into clusters of at most
``CLUSTER`` (=128) consecutive triangles; clusters are grouped by ``SUPER``
(=8) under union boxes, and each cluster holds ``SUBS`` (=4) sub-boxes of 32
triangles. A sweep (kernel K6, ops/cuda/cluster.py) walks super boxes in a
near-to-far visit order, then their child boxes, sub-boxes and Baldwin–Weber
triangle tests.

``build_clusters`` and its range builders are the JAX package's host code,
copied (numpy): the tables are built on the host and then moved to the
device, and equal the JAX package's bit for bit (tests/test_torch_accel.py).
``cluster_set_from_numpy`` carries a JAX ClusterSet's arrays across.
``visit_order`` / ``visit_orders`` run in torch on the device (stable
argsort), so a frame's visit orders cost no host round trip.

Triangle rows of ``ClusterSet.tri`` (ROWS, T_pad): the Baldwin–Weber
transform (no cross product per test; the unnormalized geometric normal and
the area come for free):
  rows 0-2   n      unnormalized geometric normal e1 x e2 (plane normal)
  row  3     nd     plane offset: n . p + nd = 0 on the triangle plane
  rows 4-6   r1     barycentric u row:  u = r1 . p + c1
  row  7     c1
  rows 8-10  r2     barycentric v row:  v = r2 . p + c2
  row  11    c2
  row  12    mat    material id (f32)
  row  13    |n|    = 2 * triangle area
  rows 14-19 sub-box [minx,miny,minz,maxx,maxy,maxz] at lanes 0..SUBS-1
  row  20    oc     cluster-local origin (box center) at lanes 0..2
  rows 21-23 spare (flat tables) / s0, the corner-0 shading normal
  rows 24-29 s1-s0, s2-s0 (smooth tables, ROWS_SMOOTH = 32)
  rows 32-37 uv0, uv1-uv0, uv2-uv0 (UV tables, ROWS_UV = 40)
The affine rows (nd, c1, c2) are rebased to each cluster's box centre, and
a sweep intersects with o' = o - oc: u, v, t stay translation-invariant.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.bvh import BVH, build_bvh_arrays
from raytracing_engine_tpu_torch.device import resolve

CLUSTER = 128  # triangles per cluster
SUPER = 8      # clusters per super-cluster
SUBS = 4       # sub-boxes per cluster (32-triangle gates)
ROWS = 24      # tri-table rows (21 used, 3 spare)
ROWS_SMOOTH = 32  # +8 rows when per-corner shading normals are stored
ROWS_UV = 40   # +8 more when per-corner texture UVs are stored

_FIELDS = ("tri", "boxes", "perm", "centroid", "super_boxes", "super_centroid",
           "order_refs")


@dataclasses.dataclass
class ClusterSet:
    tri: torch.Tensor       # (ROWS, T_pad) f32 — Baldwin–Weber rows (see above)
    boxes: torch.Tensor     # (C, 8) f32 — [min(3), max(3), 0, 0]; C a SUPER
                            #   multiple (padding clusters are all-NaN boxes)
    perm: torch.Tensor      # (T_pad,) int32 — padded slot -> original tri (-1 pad)
    centroid: torch.Tensor  # (C, 3) f32 — box centres (1e30 for padding)
    super_boxes: torch.Tensor     # (C/SUPER, 8) f32 — union AABB of SUPER children
    super_centroid: torch.Tensor  # (C/SUPER, 3) f32 — for the visit orders
    # farthest-point-sampled reference origins on the mesh (K, 3): each
    # closest-hit ray sweeps in the order of the reference nearest its own
    # origin (row 0 of a frame's table is the camera, rows 1+ these)
    order_refs: torch.Tensor | None = None
    builder: str | None = None  # the BVH builder behind it ("native"/"numpy")

    @property
    def device(self) -> torch.device:
        return self.tri.device

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[0]

    @property
    def num_super(self) -> int:
        return self.super_boxes.shape[0]

    @property
    def padded_tris(self) -> int:
        return self.tri.shape[1]

    @property
    def smooth(self) -> bool:
        """True when the table carries per-corner shading-normal rows
        (21-29): the sweep then emits interpolated normals."""
        return self.tri.shape[0] >= ROWS_SMOOTH

    @property
    def has_uv(self) -> bool:
        """True when the table carries per-corner texture-UV rows (32-37)."""
        return self.tri.shape[0] >= ROWS_UV

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in _FIELDS if getattr(self, k) is not None}

    def to(self, device) -> "ClusterSet":
        return dataclasses.replace(self, **{k: v.to(device) for k, v in self.tensors().items()})


def cluster_set_from_numpy(fields: dict, device=None, builder=None) -> ClusterSet:
    """ClusterSet from arrays by field name, e.g. a JAX ClusterSet's fields
    through ``np.asarray``. device=None is the CUDA card (device.resolve)."""
    device = resolve(device)
    out = {}
    for name in _FIELDS:
        v = fields.get(name)
        if v is None:
            out[name] = None
            continue
        dtype = torch.int32 if name == "perm" else torch.float32
        out[name] = torch.as_tensor(np.array(v), dtype=dtype).to(device).contiguous()
    return ClusterSet(**out, builder=builder)


def _subtree_ranges(bvh: dict, max_tris: int, descend: int | None = None):
    """DFS-ordered (start, end) triangle ranges, each a whole BVH subtree
    of <= max_tris triangles, greedily merging adjacent small subtrees
    (descending to subtrees of <= ``descend`` before packing)."""
    first = np.asarray(bvh["first_tri"])
    cnt = np.asarray(bvh["tri_count"])
    skip = np.asarray(bvh["skip"])
    N = first.shape[0]
    T = int(cnt[first >= 0].sum())
    # nxt[k] = first triangle index of the first leaf at preorder >= k;
    # subtree rooted at i covers tris [nxt[i], nxt[skip[i]])
    nxt = np.full((N + 1,), T, np.int64)
    for k in range(N - 1, -1, -1):
        nxt[k] = first[k] if first[k] >= 0 else nxt[k + 1]

    ranges = []
    stack = [0]
    if descend is None:
        descend = max(max_tris, 1)
    while stack:
        i = stack.pop()
        s, e = int(nxt[i]), int(nxt[min(int(skip[i]), N)])
        if e - s <= descend or first[i] >= 0:
            if e > s:
                ranges.append((s, e))
        else:
            left = i + 1
            stack.append(int(skip[left]))  # right child
            stack.append(left)             # popped first -> DFS order
    merged = [list(ranges[0])]
    for s, e in ranges[1:]:
        if e - merged[-1][0] <= max_tris:
            merged[-1][1] = e  # adjacent in DFS order = spatially coherent
        else:
            merged.append([s, e])
    return [tuple(r) for r in merged]


def _dp_ranges(ordered: np.ndarray, max_tris: int, kc: float = 0.25):
    """Optimal contiguous partition of the BVH leaf order into segments of
    <= max_tris, minimizing the sweep's expected work under the
    touch-probability ~ box-half-area model. Per candidate segment [s, s+w):

      cost = 4*OPS_SLAB * A(s, w) + 32*OPS_TEST * sum_k A(sub_k) + kc * Abar

    A = box half-area, sub_k the 32-triangle sub-windows (a partial sub
    still issues 32 tests), Abar the mean 32-triangle window area."""
    OPS_TEST, OPS_SLAB, SUB = 30.0, 28.0, 32
    T = ordered.shape[0]
    lmin = ordered.min(axis=1).astype(np.float64)  # (T, 3) per-tri box
    lmax = ordered.max(axis=1).astype(np.float64)

    def half_area(mn, mx):
        d = mx - mn
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]

    # area[w][s] = half-area of window [s, s+w), built incrementally
    area = np.full((max_tris + 1, T), np.inf)
    wmin, wmax = lmin.copy(), lmax.copy()
    area[1][:] = half_area(wmin, wmax)
    for w in range(2, max_tris + 1):
        wmin = np.minimum(wmin[: T - w + 1], lmin[w - 1:])
        wmax = np.maximum(wmax[: T - w + 1], lmax[w - 1:])
        area[w][: T - w + 1] = half_area(wmin, wmax)

    abar = float(np.mean(area[min(SUB, max_tris)][: max(T - SUB + 1, 1)]))
    const = kc * abar * (32 * OPS_TEST)  # in lane-op*area units

    # seg_cost[w-1][s] = cost of cluster [s, s+w)
    seg = np.full((max_tris, T), np.inf)
    for w in range(1, max_tris + 1):
        q, r = divmod(w, SUB)
        sub_sum = np.zeros(T)
        for k in range(q):
            sub_sum[: T - w + 1] += area[SUB][k * SUB: k * SUB + T - w + 1]
        if r:
            sub_sum[: T - w + 1] += area[r][q * SUB: q * SUB + T - w + 1]
        seg[w - 1] = 4 * OPS_SLAB * area[w] + 32 * OPS_TEST * sub_sum + const

    best = np.full(T + 1, np.inf)
    best[0] = 0.0
    take = np.zeros(T + 1, np.int32)
    ws = np.arange(1, max_tris + 1)
    for e in range(1, T + 1):
        k = min(e, max_tris)
        w = ws[:k]
        c = best[e - w] + seg[w - 1, e - w]
        j = int(np.argmin(c))
        best[e] = c[j]
        take[e] = j + 1
    ranges = []
    e = T
    while e > 0:
        s = e - int(take[e])
        ranges.append((s, e))
        e = s
    return ranges[::-1]


def build_clusters_arrays(triangles: np.ndarray, bvh: BVH | None = None,
                          tri_mats: np.ndarray | None = None,
                          align: str = "subtree", method: str = "sah",
                          descend: int | None = None, dp_kc: float = 0.25,
                          vertex_normals: np.ndarray | None = None,
                          vertex_uvs: np.ndarray | None = None):
    """The ClusterSet as numpy arrays by field name, and the BVH builder
    used ("native", "numpy", or "given" for a caller's BVH). Arguments as
    in build_clusters."""
    tris = np.asarray(triangles, np.float32)
    T = tris.shape[0]
    if bvh is None:
        bvh_arrays, builder = build_bvh_arrays(tris, method=method)
    else:
        bvh_arrays = {k: v.cpu().numpy() for k, v in bvh.tensors().items()}
        builder = "given"
    perm = np.asarray(bvh_arrays["perm"])
    ordered = tris[perm]

    if align == "subtree":
        ranges = _subtree_ranges(bvh_arrays, CLUSTER, descend=descend)
    elif align == "fixed":
        ranges = [(k * CLUSTER, min((k + 1) * CLUSTER, T))
                  for k in range(-(-T // CLUSTER))]
    elif align == "dp":
        ranges = _dp_ranges(ordered, CLUSTER, kc=dp_kc)
    else:
        raise ValueError(
            f"align must be 'subtree', 'fixed' or 'dp': {align!r}")

    # pad the cluster count to a SUPER multiple (tail clusters are NaN
    # never-hit boxes) so the super loop's inner loop is rectangular
    C = -(-len(ranges) // SUPER) * SUPER
    T_pad = C * CLUSTER
    # cluster c's tris ordered[s:e] sit at slots [c*CLUSTER, c*CLUSTER+e-s);
    # unfilled slots keep all-zero rows = never-hit triangles
    v0 = np.zeros((T_pad, 3), np.float32)
    e1 = np.zeros((T_pad, 3), np.float32)
    e2 = np.zeros((T_pad, 3), np.float32)
    perm_pad = np.full((T_pad,), -1, np.int32)
    for c, (s, e) in enumerate(ranges):
        base = c * CLUSTER
        L = e - s
        v0[base:base + L] = ordered[s:e, 0]
        e1[base:base + L] = ordered[s:e, 1] - ordered[s:e, 0]
        e2[base:base + L] = ordered[s:e, 2] - ordered[s:e, 0]
        perm_pad[base:base + L] = perm[s:e]

    # Padding boxes are ALL-NaN: NaN propagates through the slab test's
    # min/max and every comparison is false — a genuine never-hit (this is
    # why the kernel's min/max must propagate NaN, csrc/cluster.cuh).
    boxes = np.full((C, 8), np.nan, np.float32)
    boxes[:, 6:] = 0.0
    for c, (s, e) in enumerate(ranges):
        chunk = ordered[s:e].reshape(-1, 3)
        boxes[c, :3] = chunk.min(0)
        boxes[c, 3:6] = chunk.max(0)

    sub = CLUSTER // SUBS
    sub_boxes = np.full((C * SUBS, 6), np.nan, np.float32)
    for c, (s, e) in enumerate(ranges):
        for k in range(SUBS):
            lo = s + k * sub
            hi = min(s + (k + 1) * sub, e)
            if lo >= e:
                continue  # fully-padded sub-block stays NaN never-hit
            chunk = ordered[lo:hi].reshape(-1, 3)
            sub_boxes[c * SUBS + k, :3] = chunk.min(0)
            sub_boxes[c * SUBS + k, 3:6] = chunk.max(0)

    with np.errstate(invalid="ignore"):  # NaN on padded boxes
        centroid = (boxes[:, :3] + boxes[:, 3:6]) * 0.5
    centroid[~np.isfinite(centroid)] = 1e30  # padded never-hit clusters last

    # super-cluster union boxes: nanmin/nanmax ignore padded (NaN) children;
    # an all-padded super stays all-NaN = never hit
    S = T_pad // (CLUSTER * SUPER)
    sb = boxes.reshape(S, SUPER, 8)
    super_boxes = np.zeros((S, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        super_boxes[:, :3] = np.nanmin(sb[:, :, :3], 1)
        super_boxes[:, 3:6] = np.nanmax(sb[:, :, 3:6], 1)
    with np.errstate(invalid="ignore"):
        super_centroid = (super_boxes[:, :3] + super_boxes[:, 3:6]) * 0.5
    super_centroid[~np.isfinite(super_centroid)] = 1e30

    # Baldwin–Weber precompute (see the row map at the top of this module):
    #   n  = e1 x e2, nd = -n . v0
    #   r1 = (e2 x n) / (n.n), c1 = -r1.v0   (u = r1.p + c1)
    #   r2 = (n x e1) / (n.n), c2 = -r2.v0   (v = r2.p + c2)
    # Degenerate / padding triangles (|n|^2 ~ 0) get all-zero rows:
    # den = n.d = 0 makes t NaN or infinite, a genuine never-hit.
    n = np.cross(e1, e2)
    nn = np.einsum("ij,ij->i", n, n)
    ok = nn > 1e-30
    inv_nn = np.where(ok, 1.0 / np.maximum(nn, 1e-30), 0.0)[:, None]
    r1 = np.cross(e2, n) * inv_nn
    r2 = np.cross(n, e1) * inv_nn
    n = np.where(ok[:, None], n, 0.0)

    # per-corner shading normals in padded slot order (smooth tables only):
    # zero / non-finite corners fall back to the normalized face normal
    svn = None
    if vertex_normals is not None or vertex_uvs is not None:
        svn = np.zeros((3, T_pad, 3), np.float32)
        if vertex_normals is not None:
            vn_arr = np.asarray(vertex_normals, np.float32)
            if vn_arr.shape != (T, 3, 3):
                raise ValueError(
                    f"vertex_normals must be (T, 3, 3) matching triangles; "
                    f"got {vn_arr.shape} for T={T}")
            vn_ord = vn_arr[perm]
            for c, (s, e) in enumerate(ranges):
                base = c * CLUSTER
                for k in range(3):
                    svn[k, base:base + (e - s)] = vn_ord[s:e, k]
        nf = n / np.maximum(np.sqrt(nn), 1e-30)[:, None]
        for k in range(3):
            ln = np.linalg.norm(svn[k], axis=1)
            good = np.isfinite(ln) & (ln > 1e-12)
            svn[k] = np.where(good[:, None],
                              svn[k] / np.maximum(ln, 1e-30)[:, None], nf)
    suv = None
    if vertex_uvs is not None:
        uv_arr = np.asarray(vertex_uvs, np.float32)
        if uv_arr.shape != (T, 3, 2):
            raise ValueError(
                f"vertex_uvs must be (T, 3, 2) matching triangles; got "
                f"{uv_arr.shape} for T={T}")
        uv_ord = uv_arr[perm]
        suv = np.zeros((3, T_pad, 2), np.float32)
        for c, (s, e) in enumerate(ranges):
            base = c * CLUSTER
            for k in range(3):
                suv[k, base:base + (e - s)] = uv_ord[s:e, k]
    # per-slot cluster-local origin (box center; 0 for padded clusters)
    with np.errstate(invalid="ignore"):
        oc_cluster = np.where(np.isfinite(boxes[:, 0:1]),
                              (boxes[:, 0:3] + boxes[:, 3:6]) * 0.5, 0.0)
    oc_cluster = oc_cluster.astype(np.float32)
    oc = np.repeat(oc_cluster, CLUSTER, axis=0)  # (T_pad, 3)
    v0l = v0 - oc
    nd = -np.einsum("ij,ij->i", n, v0l)
    c1 = -np.einsum("ij,ij->i", r1, v0l)
    c2 = -np.einsum("ij,ij->i", r2, v0l)

    n_rows = (ROWS_UV if suv is not None
              else ROWS_SMOOTH if svn is not None else ROWS)
    tri_rows = np.zeros((n_rows, T_pad), np.float32)
    tri_rows[0:3] = n.T
    tri_rows[3] = nd
    tri_rows[4:7] = r1.T
    tri_rows[7] = c1
    tri_rows[8:11] = r2.T
    tri_rows[11] = c2
    if tri_mats is not None:
        mats = np.asarray(tri_mats, np.float32)[perm]
        for c, (s, e) in enumerate(ranges):
            base = c * CLUSTER
            tri_rows[12, base:base + (e - s)] = mats[s:e]
    tri_rows[13] = np.sqrt(nn)  # |n| = 2 * area
    tri_rows[20].reshape(C, CLUSTER)[:, 0:3] = oc_cluster
    for c in range(C):
        for s in range(SUBS):
            tri_rows[14:20, c * CLUSTER + s] = sub_boxes[c * SUBS + s]
    if svn is not None:  # rows 21-29: s0, s1-s0, s2-s0
        tri_rows[21:24] = svn[0].T
        tri_rows[24:27] = (svn[1] - svn[0]).T
        tri_rows[27:30] = (svn[2] - svn[0]).T
    if suv is not None:  # rows 32-37: uv0, uv1-uv0, uv2-uv0
        tri_rows[32:34] = suv[0].T
        tri_rows[34:36] = (suv[1] - suv[0]).T
        tri_rows[36:38] = (suv[2] - suv[0]).T
    # farthest-point sample of the (finite) super centroids: the reference
    # origins of the per-ray visit orders
    finite = super_centroid[np.abs(super_centroid[:, 0]) < 1e29]
    k_refs = min(7, finite.shape[0])
    refs = np.zeros((k_refs, 3), np.float32)
    if k_refs:
        refs[0] = finite[0]
        d2 = ((finite - refs[0]) ** 2).sum(1)
        for i in range(1, k_refs):
            refs[i] = finite[int(np.argmax(d2))]
            d2 = np.minimum(d2, ((finite - refs[i]) ** 2).sum(1))

    return dict(tri=tri_rows, boxes=boxes, perm=perm_pad, centroid=centroid,
                super_boxes=super_boxes, super_centroid=super_centroid,
                order_refs=refs), builder


def build_clusters(triangles: np.ndarray, bvh: BVH | None = None,
                   tri_mats: np.ndarray | None = None,
                   align: str = "subtree", method: str = "sah",
                   descend: int | None = None,
                   dp_kc: float = 0.25,
                   vertex_normals: np.ndarray | None = None,
                   vertex_uvs: np.ndarray | None = None,
                   device=None) -> ClusterSet:
    """triangles: (T, 3, 3). Built on the host with the BVH leaf order
    (a BVH is built here unless given: native if g++ builds it, else numpy),
    then moved to `device` (None: the CUDA card). Padding: a CLUSTER
    multiple of degenerate triangles inside NaN never-hit boxes.

    tri_mats: optional (T,) material ids, stored in tri row 12.
    vertex_normals: optional (T, 3, 3) per-corner shading normals (rows
    21-29, a smooth table). vertex_uvs: optional (T, 3, 2) per-corner UVs
    (rows 32-37; implies the smooth rows). align: "subtree" (clusters cut
    at BVH subtree boundaries), "fixed" (exact 128-chunks of the leaf
    order) or "dp" (the cost-model-optimal contiguous partition). method:
    the BVH partitioner ("sah" or "median")."""
    arrays, builder = build_clusters_arrays(
        triangles, bvh, tri_mats, align, method, descend, dp_kc,
        vertex_normals, vertex_uvs)
    return cluster_set_from_numpy(arrays, device, builder=builder)


def visit_orders(cs: ClusterSet, origins) -> torch.Tensor:
    """(P, 3) origins -> (P, S) int32 near-to-far SUPER orders (one row per
    origin; a stable argsort of squared distances, on the origins' device).
    A pure perf hint: results do not depend on it, except which of two
    triangles at exactly the same distance wins."""
    o = origins.to(torch.float32)
    d = cs.super_centroid[None, :, :] - o[:, None, :]
    dist = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.argsort(dist, dim=-1, stable=True).to(torch.int32)


def visit_order(cs: ClusterSet, origin) -> torch.Tensor:
    """Near-to-far SUPER-cluster visit order (S,) int32 from one origin (3,)."""
    return visit_orders(cs, origin.reshape(1, 3))[0]
