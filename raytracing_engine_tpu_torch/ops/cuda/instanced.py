"""K7: the instanced cluster intersector through the CUDA kernel
``instanced_kernel`` (csrc/instanced.cu, sweep in csrc/instanced.cuh), which
replaces raytracing_engine_tpu/ops/pallas/instanced_intersect.py
``_instanced_kernel``.

``instanced_cluster_intersect`` keeps the JAX signature and results: t
(+inf on a miss) and the hit code instance * cs.padded_tris + slot (int32,
-1 on a miss), plus the unnormalized world-space normal (nx, ny, nz) with
``attrs=True``, and on a base ClusterSet with UV rows the hit's texture (u,
v) after it (object-space data, carried untransformed) and with
``tan=True`` its texture-u tangent turned into world space by the
instance's rotation, as the normal is. ``origin`` orders the instances near to far from it and
gives each instance the super order of that origin moved into its object
space (``instance_orders``); without it the orders are the identity.
Either way the kernel and the plain version take the same orders, and agree
bit for bit. ``tile`` and ``interpret`` are TPU knobs, accepted and ignored.
Rays on the CPU take the plain
version, ``instanced_cluster_intersect_reference``; rays on a CUDA device
launch the kernel or raise.

The kernel sweeps with the 32 lanes of a warp together (csrc/cluster.cuh
sweep_warp).

``FrameInstances`` is the in-kernel view of one frame (the JAX megakernel's
KernelInstances): the orders from the camera, which K4 and K5 take and the
plain wavefront replays. ``work`` counts the instance gates and transforms
of the plain version; its cluster sweeps count their box and triangle tests
in ops/cuda/cluster.work.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.clusters import ClusterSet, visit_orders
from raytracing_engine_tpu_torch.accel.instancing import InstancedClusters
from raytracing_engine_tpu_torch.ops.cuda import cluster as kcluster
from raytracing_engine_tpu_torch.ops.cuda import common

INST_W = 24  # instance record width (csrc/instanced.cuh kInstW)
_INF = float("inf")

# kernel launches since the count was last set to 0 (plain-version calls
# do not count), and those of them on a UV base table with attributes
# (instanced_uv_kernel)
launches = 0
uv_launches = 0
# the plain version's instance work since it was last set to 0: world-box
# gates (per ray and instance visited) and object-space transforms (per ray
# and instance entered)
work = {"gates": 0, "transforms": 0}


class InstanceTables(ctypes.Structure):
    """Mirror of ``ins::Instances`` (csrc/instanced.cuh), field for field."""

    _fields_ = [
        ("tab", ctypes.c_void_p),
        ("iorder", ctypes.c_void_p),
        ("iorders", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("t_pad", ctypes.c_int),
    ]


class InstancedArgs(ctypes.Structure):
    """Mirror of ``ins::Args`` (csrc/instanced.cu), field for field."""

    _fields_ = [
        ("tables", kcluster.ClusterTables),
        ("inst", InstanceTables),
        ("ox", ctypes.c_void_p),
        ("oy", ctypes.c_void_p),
        ("oz", ctypes.c_void_p),
        ("dx", ctypes.c_void_p),
        ("dy", ctypes.c_void_p),
        ("dz", ctypes.c_void_p),
        ("tmax", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("out_code", ctypes.c_void_p),
        ("out_n", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("t_min", ctypes.c_float),
        ("any_hit", ctypes.c_int),
        ("device", ctypes.c_int),
        ("tuv", ctypes.c_void_p),
        ("out_uv", ctypes.c_void_p),
        ("tan", ctypes.c_int),
    ]


def pack_instances(inst, mats=None) -> torch.Tensor:
    """accel.instancing.InstancedMesh -> the (N, 24) f32 instance table on
    its device: [inv_rot (9, row-major), trans (3), scale, world bb_min (3),
    world bb_max (3), mat, 0 x4]. Column 19 carries the per-instance
    material id (from `mats` or InstancedMesh.mat)."""
    n = inst.num_instances
    dev = inst.trans.device
    if mats is None:
        mats = getattr(inst, "mat", None)
    if mats is None:
        mats = torch.zeros((n,), dtype=torch.float32, device=dev)
    return torch.cat([
        inst.inv_rot.reshape(n, 9),
        inst.trans,
        inst.scale[:, None],
        inst.aabb_min,
        inst.aabb_max,
        torch.as_tensor(mats, dtype=torch.float32, device=dev)[:, None],
        torch.zeros((n, 4), dtype=torch.float32, device=dev),
    ], 1)


def object_space_origins(inst_tab, origin) -> torch.Tensor:
    """(N, 24) table + world origin (3,) -> (N, 3): R_k^T (origin - trans_k)
    / s_k, the origin in each instance's object space."""
    inv = inst_tab[:, 0:9]
    rel = torch.as_tensor(origin, dtype=torch.float32, device=inst_tab.device) - inst_tab[:, 9:12]
    rows = [inv[:, 3 * i] * rel[:, 0] + inv[:, 3 * i + 1] * rel[:, 1]
            + inv[:, 3 * i + 2] * rel[:, 2] for i in range(3)]
    return torch.stack(rows, 1) / inst_tab[:, 12:13]


def instance_orders(inst_tab, cs: ClusterSet, origin=None):
    """(iorder (N,) int32, iorders (N, S) int32) on the table's device: the
    instances near to far from `origin` by their box centres (a stable
    argsort) and each instance's super order from the origin in its object
    space; the identity orders without an origin. Perf hints: results do not
    depend on them, except which of two hits at exactly the same t wins."""
    n, S = inst_tab.shape[0], cs.num_super
    dev = inst_tab.device
    if origin is None:
        iorder = torch.arange(n, dtype=torch.int32, device=dev)
        iorders = torch.arange(S, dtype=torch.int32, device=dev).expand(n, S)
    else:
        origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
        center = (inst_tab[:, 13:16] + inst_tab[:, 16:19]) * 0.5
        delta = center - origin
        dist = delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1] + delta[:, 2] * delta[:, 2]
        iorder = torch.argsort(dist, stable=True).to(torch.int32)
        iorders = visit_orders(cs, object_space_origins(inst_tab, origin))
    return iorder.contiguous(), iorders.contiguous()


@dataclasses.dataclass
class FrameInstances:
    """An InstancedClusters with one frame's orders from the camera: the
    view K4 and K5 sweep and the plain wavefront replays (the JAX
    megakernel's KernelInstances, pt_kernel.py:600-619)."""

    ic: InstancedClusters
    iorder: torch.Tensor   # (N,) int32
    iorders: torch.Tensor  # (N, S) int32

    @classmethod
    def at(cls, ic: InstancedClusters, origin) -> "FrameInstances":
        return cls(ic, *instance_orders(ic.inst_tab, ic.cs, origin))


def _sweep(tab, iorder, iorders, tb, t_pad: int, o, d, t0, t_min: float, any_hit: bool,
           attrs: bool, tan: bool = False):
    """The plain two-level sweep over flat (n,) planes (csrc/instanced.cuh
    instanced_sweep_warp's result for each ray, as one batch): -> (t, code
    int64, attribute planes or None); t = t0 where code < 0. The attribute
    planes: the world normal, then on a UV table (tb.tuv) the UV, and with
    tan the world tangent. tab: the instance table as a numpy (N, 24) f32
    array; iorder: a list of ints."""
    dev = o[0].device
    n = o[0].numel()
    t_w = t0.clone()
    code = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if any_hit:
        code = torch.where(o[0].abs() >= kcluster.PARKED, 0, code)
    n_attr = 3 + (0 if tb.tuv is None else (5 if tan else 2))
    nrm = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(n_attr)] if attrs else None
    winv = tuple(torch.reciprocal(c) for c in d)
    f32 = np.float32
    for k in iorder:
        r = [float(x) for x in tab[k]]
        act = torch.nonzero(code < 0).squeeze(1) if any_hit else torch.arange(n, device=dev)
        if act.numel() == 0:
            break
        work["gates"] += act.numel()
        box = torch.tensor([r[13:19]], dtype=torch.float32, device=dev)
        g = kcluster._slab_gate(box, tuple(c[act] for c in o), tuple(c[act] for c in winv),
                                t_min, t_w[act])
        a = act[g]
        if a.numel() == 0:
            continue
        work["transforms"] += a.numel()
        s = r[12]
        inv_s = float(f32(1.0) / f32(s))
        sx, sy, sz = o[0][a] - r[9], o[1][a] - r[10], o[2][a] - r[11]
        wd = tuple(c[a] for c in d)
        oo = tuple((r[3 * i] * sx + r[3 * i + 1] * sy + r[3 * i + 2] * sz) * inv_s
                   for i in range(3))
        dd = tuple(r[3 * i] * wd[0] + r[3 * i + 1] * wd[1] + r[3 * i + 2] * wd[2]
                   for i in range(3))
        t_obj, sidx, uu, vv = kcluster._sweep(tb, oo, dd, t_w[a] * inv_s,
                                              float(f32(t_min) * f32(inv_s)), any_hit,
                                              iorders[k], None, None)
        upd = sidx >= 0
        t_w[a] = torch.where(upd, t_obj * s, t_w[a])
        code[a] = torch.where(upd, k * t_pad + sidx, code[a])
        if attrs:
            at = kcluster._attrs(tb, sidx, uu, vv, tan)

            def world(vec):  # object -> world: R vec, as the normal turns
                return [r[c] * vec[0] + r[3 + c] * vec[1] + r[6 + c] * vec[2] for c in range(3)]

            # the normal, the UV (object-space data, untransformed), the tangent
            new = world(at[:3]) + list(at[5:7]) + (world(at[7:10]) if len(at) > 7 else [])
            for c, w in enumerate(new):
                nrm[c][a] = torch.where(upd, w, nrm[c][a])
    return t_w, code, nrm


def instanced_cluster_intersect_reference(inst_tab, cs: ClusterSet, o_planes, d_planes,
                                          t_min=1e-3, tile=(16, 256), interpret=None,
                                          any_hit=False, attrs=False, t_max=_INF, origin=None,
                                          tan=False, iorder=None, iorders=None):
    """Plain PyTorch version of instanced_cluster_intersect (same arguments
    and results; explicit iorder / iorders, FrameInstances' orders, replace
    those of `origin`); it counts its work in ``work`` and
    ops/cuda/cluster.work."""
    del tile, interpret
    shape, o, d, t0 = common.flat_rays(o_planes, d_planes, t_max)
    if iorder is None or iorders is None:
        iorder, iorders = instance_orders(inst_tab, cs, origin)
    tb = kcluster.sweep_tables(cs)
    t, code, nrm = _sweep(inst_tab.cpu().numpy(), iorder.tolist(), iorders, tb, cs.padded_tris,
                          o, d, t0, float(t_min), any_hit, attrs, tan)
    out = (torch.where(code >= 0, t, _INF).reshape(shape), code.to(torch.int32).reshape(shape))
    if attrs:
        out += tuple(c.reshape(shape) for c in nrm)
    return out


def instance_struct(inst_tab, cs: ClusterSet, iorder, iorders) -> InstanceTables:
    """ins::Instances of the table and its orders, after checking them
    (tensors kept alive by the caller until the launch has been enqueued)."""
    dev, n = cs.device, inst_tab.shape[0]
    common.check(inst_tab, "inst_tab", (n, INST_W), torch.float32, dev)
    common.check(iorder, "iorder", (n,), torch.int32, dev)
    common.check(iorders, "iorders", (n, cs.num_super), torch.int32, dev)
    if n * cs.padded_tris >= 2 ** 31:
        raise ValueError(f"{n} instances x {cs.padded_tris} slots overflow the int32 hit code")
    return InstanceTables(tab=inst_tab.data_ptr(), iorder=iorder.data_ptr(),
                          iorders=iorders.data_ptr(), n=n, t_pad=cs.padded_tris)


def instanced_cluster_intersect(inst_tab, cs: ClusterSet, o_planes, d_planes, t_min=1e-3,
                                tile=(16, 256), interpret=None, any_hit=False, attrs=False,
                                t_max=_INF, origin=None, tan=False, iorder=None, iorders=None):
    """Closest hit (or any-hit occlusion) of a grid of rays over every
    instance of the base ClusterSet `cs`: (t, code int32), t = +inf and code
    = -1 on a miss, code = instance * cs.padded_tris + slot; attrs=True
    appends (nx, ny, nz), the unnormalized world normal (0 on a miss), and on
    a base set with UV rows (u, v), then with tan=True (tx, ty, tz), the
    world texture-u tangent (0 on a miss; tan is ignored without UVs, as in
    the JAX package). inst_tab: pack_instances(...). t_max: a scalar or a plane (the shadow
    cutoff). origin: (3,) representative origin for the visit orders
    (instance_orders); None: the identity orders. iorder / iorders: orders
    already made by instance_orders, which replace those of `origin`."""
    global launches, uv_launches
    if o_planes[0].device.type == "cpu":
        return instanced_cluster_intersect_reference(
            inst_tab, cs, o_planes, d_planes, t_min, tile, interpret, any_hit, attrs, t_max,
            origin, tan, iorder, iorders)
    dev = cs.device
    if dev.type != "cuda" or o_planes[0].device != dev:
        raise ValueError(f"rays on {o_planes[0].device}, ClusterSet on {dev}: the CUDA "
                         "kernel needs both on one CUDA device")
    shape, o, d, t0 = common.flat_rays(o_planes, d_planes, t_max)
    if iorder is None or iorders is None:
        iorder, iorders = instance_orders(inst_tab, cs, origin)
    tb = kcluster.sweep_tables(cs)
    order = torch.arange(cs.num_super, dtype=torch.int32, device=dev)
    n = t0.numel()
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_code = torch.empty(n, dtype=torch.int32, device=dev)
    out_n = torch.empty((3, n), dtype=torch.float32, device=dev) if attrs else None
    tan = bool(tan and attrs and tb.tuv is not None)
    out_uv = None
    if attrs and tb.tuv is not None:
        out_uv = torch.empty((5 if tan else 2, n), dtype=torch.float32, device=dev)
    args = InstancedArgs(
        tables=kcluster.tables_struct(tb, order),
        inst=instance_struct(inst_tab, cs, iorder, iorders),
        ox=o[0].data_ptr(), oy=o[1].data_ptr(), oz=o[2].data_ptr(),
        dx=d[0].data_ptr(), dy=d[1].data_ptr(), dz=d[2].data_ptr(), tmax=t0.data_ptr(),
        out_t=out_t.data_ptr(), out_code=out_code.data_ptr(),
        out_n=0 if out_n is None else out_n.data_ptr(),
        n=n, t_min=float(np.float32(t_min)), any_hit=int(any_hit),
        device=dev.index if dev.index is not None else torch.cuda.current_device(),
        tuv=0 if out_uv is None else tb.tuv.data_ptr(),
        out_uv=0 if out_uv is None else out_uv.data_ptr(), tan=int(tan))
    common.launch("instanced_intersect", args, name="instanced")
    launches += 1
    uv_launches += int(out_uv is not None)
    out = (out_t.reshape(shape), out_code.reshape(shape))
    if attrs:
        out += tuple(out_n[a].reshape(shape) for a in range(3))
    if out_uv is not None:
        out += tuple(out_uv[a].reshape(shape) for a in range(out_uv.shape[0]))
    return out
