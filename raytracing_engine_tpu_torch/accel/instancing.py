"""Two-level acceleration: instanced meshes over one shared base mesh
(raytracing_engine_tpu/accel/instancing.py; BASELINE config 5).

- ``InstancedMesh``: N instances of a base mesh's BVH, each a rotation, a
  translation and a uniform scale, with the world AABBs precomputed (the
  transform of the BVH's root box). ``make_instances`` and
  ``grid_instances`` build it on the host in numpy, exactly as the JAX
  package does, so the fields equal JAX's bit for bit; then move it to the
  device.
- ``instanced_intersect``: the plain two-level gather oracle, a loop over
  instances around ``accel.bvh.bvh_intersect`` in each object space.
- ``InstancedClusters``: the path tracer's container, the base mesh's
  ClusterSet and the packed (N, 24) instance table (ops/cuda/instanced.py
  ``pack_instances``; column 19 is each instance's material). Passed as
  ``bvh`` it makes the renderers intersect through kernel K7
  (``render_pt_fast``) or its sweep inside K4 and K5 (``render_pt_mega``,
  ``render_pt_rebin``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.bvh import BVH, bvh_intersect
from raytracing_engine_tpu_torch.device import resolve

_FIELDS = ("rot", "inv_rot", "trans", "scale", "mat", "aabb_min", "aabb_max")


@dataclasses.dataclass
class InstancedMesh:
    bvh: BVH
    rot: torch.Tensor       # (N, 3, 3) object->world rotation
    inv_rot: torch.Tensor   # (N, 3, 3) world->object rotation
    trans: torch.Tensor     # (N, 3) world translation
    scale: torch.Tensor     # (N,) uniform scale
    mat: torch.Tensor       # (N,) int32 material per instance
    aabb_min: torch.Tensor  # (N, 3) world-space instance bounds
    aabb_max: torch.Tensor  # (N, 3)

    @property
    def num_instances(self) -> int:
        return self.trans.shape[0]

    @property
    def total_triangles(self) -> int:
        return self.num_instances * self.bvh.v0.shape[0]

    def to(self, device) -> "InstancedMesh":
        return dataclasses.replace(self, bvh=self.bvh.to(device),
                                   **{k: getattr(self, k).to(device) for k in _FIELDS})


def _rotation_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def make_instances(bvh: BVH, transforms, mats=None, device=None) -> InstancedMesh:
    """transforms: sequence of (rotation (3,3), translation (3,), scale).
    Precomputes inverses and world AABBs (transform of the BVH root box) on
    the host; the result lives on `device` (None: the CUDA card)."""
    device = resolve(device)
    rots = np.stack([np.asarray(r, np.float32) for r, _, _ in transforms])
    trans = np.stack([np.asarray(t, np.float32) for _, t, _ in transforms])
    scales = np.array([s for _, _, s in transforms], np.float32)
    inv = np.transpose(rots, (0, 2, 1))  # orthonormal
    n = len(transforms)
    mats = np.zeros((n,), np.int32) if mats is None else np.asarray(mats, np.int32)

    root_lo = bvh.bb_min[0].cpu().numpy()
    root_hi = bvh.bb_max[0].cpu().numpy()
    cs = np.array(np.meshgrid(
        [root_lo[0], root_hi[0]], [root_lo[1], root_hi[1]],
        [root_lo[2], root_hi[2]],
    )).T.reshape(-1, 3)  # (8, 3) object-space corners
    world = (
        np.einsum("nij,kj->nki", rots, cs) * scales[:, None, None]
        + trans[:, None, :]
    )
    arrays = dict(rot=rots, inv_rot=inv, trans=trans, scale=scales, mat=mats,
                  aabb_min=world.min(axis=1), aabb_max=world.max(axis=1))
    return InstancedMesh(bvh=bvh.to(device),
                         **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                            for k, v in arrays.items()})


def grid_instances(bvh: BVH, nx: int, ny: int, spacing: float = 3.0,
                   base=(0.0, 10.0, 0.0), mats=None, device=None) -> InstancedMesh:
    """nx*ny instances in a rotated grid — the config-5 scene generator."""
    transforms = []
    for i in range(nx):
        for j in range(ny):
            theta = 0.7 * (i * ny + j)
            t = (
                base[0] + (i - (nx - 1) / 2) * spacing,
                base[1] + j * spacing,
                base[2] + 0.4 * ((i + j) % 3),
            )
            transforms.append((_rotation_z(theta), t, 1.0))
    return make_instances(bvh, transforms, mats, device=device)


def instanced_intersect(inst: InstancedMesh, o3, d3, t_min=1e-3):
    """Closest hit over all instances: the plain two-level oracle.

    o3/d3: (..., 3). Returns (t_world, instance_idx int32, tri_idx int32,
    normal (..., 3)): t = +inf and the indices -1 on a miss; tri_idx is
    REORDERED (inst.bvh.perm maps it back). Normals are geometric,
    world-space, unit, unoriented."""
    n = inst.num_instances
    batch = tuple(o3.shape[:-1])
    dev = o3.device
    best_t = torch.full(batch, float("inf"), dtype=torch.float32, device=dev)
    best_inst = torch.full(batch, -1, dtype=torch.int32, device=dev)
    best_tri = torch.full(batch, -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    e1, e2 = inst.bvh.e1, inst.bvh.e2
    for k in range(n):
        inv = inst.inv_rot[k]
        s = inst.scale[k]
        oo = torch.einsum("ij,...j->...i", inv, o3 - inst.trans[k]) / s
        dd = torch.einsum("ij,...j->...i", inv, d3)
        t_obj, ridx, _, _ = bvh_intersect(inst.bvh, oo, dd, t_min=t_min / s, t_max=best_t / s)
        t_w = t_obj * s
        ok = (ridx >= 0) & (t_w < best_t)
        safe = torch.clamp_min(ridx, 0).to(torch.int64)
        n_obj = torch.linalg.cross(e1[safe], e2[safe], dim=-1)
        n_w = torch.einsum("ij,...j->...i", inst.rot[k], n_obj)
        best_t = torch.where(ok, t_w, best_t)
        best_inst = torch.where(ok, k, best_inst)
        best_tri = torch.where(ok, ridx, best_tri)
        best_n = torch.where(ok[..., None], n_w, best_n)
    nl = torch.clamp_min(torch.linalg.norm(best_n, dim=-1, keepdim=True), 1e-20)
    return best_t, best_inst, best_tri, best_n / nl


@dataclasses.dataclass
class InstancedClusters:
    """The two-level path-tracing container: the shared base-mesh
    ClusterSet and the packed instance table (ops/cuda/instanced.py
    pack_instances; column 19 = per-instance material id)."""

    inst_tab: torch.Tensor  # (N, 24) f32
    cs: object              # accel.clusters.ClusterSet

    @property
    def num_instances(self) -> int:
        return self.inst_tab.shape[0]

    def to(self, device) -> "InstancedClusters":
        return InstancedClusters(inst_tab=self.inst_tab.to(device), cs=self.cs.to(device))


def make_instanced_clusters(inst: InstancedMesh, cs, scene=None,
                            device=None) -> InstancedClusters:
    """The path tracer's container from an InstancedMesh and its base
    ClusterSet, on `device` (None: the CUDA card).

    scene: optional PTScene; when given, per-instance materials whose
    emission is nonzero are refused: instanced emissive surfaces have no
    NEE light-table entry and no MIS pdf, so they would silently lose
    energy. Area lights in instanced scenes are emissive spheres or
    unrolled-slot triangles."""
    from raytracing_engine_tpu_torch.ops.cuda.instanced import pack_instances

    device = resolve(device)
    if scene is not None:
        mats = inst.mat.cpu().numpy()
        emiss = scene.mat_emission.cpu().numpy()
        bad = [int(k) for k in range(mats.shape[0]) if np.any(emiss[mats[k]] > 0)]
        if bad:
            raise ValueError(
                f"instances {bad} use emissive materials: instanced "
                f"emissive surfaces are not NEE-sampleable (no light-table "
                f"entry / MIS pdf). Use emissive spheres or unrolled-slot "
                f"triangles as area lights in instanced scenes.")
    return InstancedClusters(inst_tab=pack_instances(inst).to(device).contiguous(),
                             cs=cs if cs.device == device else cs.to(device))
