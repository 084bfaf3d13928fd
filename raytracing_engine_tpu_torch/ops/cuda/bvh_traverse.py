"""K8: the skip-link BVH traversal through the CUDA kernel ``traverse_kernel``
(csrc/bvh.cu), which replaces raytracing_engine_tpu/ops/pallas/
bvh_traverse.py ``_traverse_kernel``.

``bvh_intersect_packet`` keeps the JAX signature and results: t (+inf on a
miss) and the REORDERED triangle index (-1 on a miss; ``bvh.perm`` maps it
back) of an (H, W) grid of rays, closest hit or, with ``any_hit``, the first
confirmed hit below t_max. ``tile`` and ``interpret`` are TPU knobs,
accepted and ignored. Rays on the CPU take the plain version,
``bvh_intersect_packet_reference`` (accel/bvh.py ``traverse``, JAX
``bvh_intersect``); rays on a CUDA device launch the kernel or raise.

Each ray walks its own node cursor (the TPU kernel walks one per tile), so
per ray the kernel visits the nodes the plain traversal visits, in the same
order, and agrees with it bit for bit. ``work`` counts the node and
triangle tests the plain version made, for the kernel's bound
(utils/timing.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.bvh import BVH, traverse
from raytracing_engine_tpu_torch.device import resolve
from raytracing_engine_tpu_torch.ops.cuda import common

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0
# tests the plain version performed since they were last set to 0: node box
# tests and Möller-Trumbore triangle tests
work = {"nodes": 0, "tests": 0}


class TraverseArgs(ctypes.Structure):
    """Mirror of ``bvh::Args`` (csrc/bvh.cu), field for field."""

    _fields_ = [
        ("node_bb", ctypes.c_void_p),
        ("node_meta", ctypes.c_void_p),
        ("tri", ctypes.c_void_p),
        ("ox", ctypes.c_void_p),
        ("oy", ctypes.c_void_p),
        ("oz", ctypes.c_void_p),
        ("dx", ctypes.c_void_p),
        ("dy", ctypes.c_void_p),
        ("dz", ctypes.c_void_p),
        ("tmax", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("out_idx", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("n_nodes", ctypes.c_int),
        ("n_tris", ctypes.c_int),
        ("t_min", ctypes.c_float),
        ("any_hit", ctypes.c_int),
        ("max_steps", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


@dataclasses.dataclass
class BVHTables:
    """A BVH as the kernel reads it (csrc/bvh.cu): one record per node and
    per triangle, nothing transposed."""

    node_bb: torch.Tensor    # (N, 8) f32 [min(3), max(3), 0, 0]
    node_meta: torch.Tensor  # (N, 4) int32 [first_tri, tri_count, skip, 0]
    tri: torch.Tensor        # (T, 12) f32 [v0(3), e1(3), e2(3), 0 x3]

    @property
    def device(self) -> torch.device:
        return self.node_bb.device


def pack_bvh_tables(bvh: BVH, device=None) -> BVHTables:
    """The kernel's records of `bvh`, on `device` (None: the CUDA card)."""
    device = resolve(device)
    f32, i32 = torch.float32, torch.int32
    n, t = bvh.bb_min.shape[0], bvh.v0.shape[0]
    dev = bvh.device
    node_bb = torch.cat([bvh.bb_min, bvh.bb_max, torch.zeros((n, 2), dtype=f32, device=dev)], 1)
    node_meta = torch.stack([bvh.first_tri.to(i32), bvh.tri_count.to(i32), bvh.skip.to(i32),
                             torch.zeros(n, dtype=i32, device=dev)], 1)
    tri = torch.cat([bvh.v0, bvh.e1, bvh.e2, torch.zeros((t, 3), dtype=f32, device=dev)], 1)
    return BVHTables(*(x.to(device).contiguous() for x in (node_bb, node_meta, tri)))


def tables_of(bvh: BVH) -> BVHTables:
    """pack_bvh_tables(bvh) on bvh's own device, built once per BVH."""
    cached = bvh.__dict__.get("_k8_tables")
    if cached is None:
        cached = bvh.__dict__["_k8_tables"] = pack_bvh_tables(bvh, bvh.device)
    return cached


def bvh_intersect_packet_reference(tables: BVHTables, o_planes, d_planes, t_max, t_min=1e-3,
                                   any_hit=False, tile=(16, 256), interpret=None,
                                   max_steps=500_000):
    """Plain PyTorch version of bvh_intersect_packet (same arguments and
    results); it counts its tests in ``work``."""
    del tile, interpret
    shape, o, d, t0 = common.flat_rays(o_planes, d_planes, t_max)
    nb, tri = tables.node_bb, tables.tri
    meta = tables.node_meta
    t, idx, _, _ = traverse(nb[:, 0:3], nb[:, 3:6], meta[:, 0], meta[:, 1], meta[:, 2],
                            tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], o, d, t0, float(t_min),
                            any_hit, max_steps, work)
    return t.reshape(shape), idx.to(torch.int32).reshape(shape)


def bvh_intersect_packet(tables: BVHTables, o_planes, d_planes, t_max, t_min=1e-3,
                         any_hit=False, tile=(16, 256), interpret=None, max_steps=500_000):
    """Traverse the BVH of `tables` (pack_bvh_tables) for a grid of rays
    (planes of any shape): (t, tri_idx int32), t = +inf and tri_idx = -1 on
    a miss, tri_idx REORDERED. t_max: a scalar or a plane, the initial t
    (the any-hit cutoff). max_steps caps the nodes each ray visits."""
    global launches
    if o_planes[0].device.type == "cpu":
        return bvh_intersect_packet_reference(tables, o_planes, d_planes, t_max, t_min,
                                              any_hit, tile, interpret, max_steps)
    dev = tables.device
    if dev.type != "cuda" or o_planes[0].device != dev:
        raise ValueError(f"rays on {o_planes[0].device}, BVH tables on {dev}: the CUDA "
                         "kernel needs both on one CUDA device")
    n_nodes, n_tris = tables.node_bb.shape[0], tables.tri.shape[0]
    common.check(tables.node_bb, "node_bb", (n_nodes, 8), torch.float32, dev)
    common.check(tables.node_meta, "node_meta", (n_nodes, 4), torch.int32, dev)
    common.check(tables.tri, "tri", (n_tris, 12), torch.float32, dev)
    if n_tris == 0:
        raise ValueError("a BVH without triangles")
    shape, o, d, t0 = common.flat_rays(o_planes, d_planes, t_max)
    n = t0.numel()
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    args = TraverseArgs(
        node_bb=tables.node_bb.data_ptr(), node_meta=tables.node_meta.data_ptr(),
        tri=tables.tri.data_ptr(),
        ox=o[0].data_ptr(), oy=o[1].data_ptr(), oz=o[2].data_ptr(),
        dx=d[0].data_ptr(), dy=d[1].data_ptr(), dz=d[2].data_ptr(), tmax=t0.data_ptr(),
        out_t=out_t.data_ptr(), out_idx=out_idx.data_ptr(),
        n=n, n_nodes=n_nodes, n_tris=n_tris, t_min=float(np.float32(t_min)),
        any_hit=int(any_hit), max_steps=int(max_steps),
        device=dev.index if dev.index is not None else torch.cuda.current_device())
    common.launch("bvh_traverse", args, name="bvh")
    launches += 1
    return out_t.reshape(shape), out_idx.reshape(shape)
