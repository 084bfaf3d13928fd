"""The plain PyTorch path tracer: the oracle of kernels K4 and K5 and the
CPU renderer (raytracing_engine_tpu/pathtracer/wavefront.py).

Same estimator and the same sample streams as the JAX wavefront: NEE
toward power- or uniform-selected sphere and triangle lights and, with an
env map, toward the map's alias-sampled texels (one coin splits the two),
with power-heuristic MIS, DIFFUSE / MIRROR / DIELECTRIC (smooth, or rough
by Walter 2007; with spectral dispersion) / METAL (GGX, isotropic or
anisotropic) / emissive materials, checkers in world or UV space, image
textures from the atlas (nearest, bilinear, or trilinear across the mip
chains by a ray cone), tangent-space normal maps, a constant or gradient sky
or the env map, optional Russian roulette. Per-ray state is component
planes of any shape, and every expression keeps the JAX operation order,
because csrc/pt.cuh is held to this code on the card.

Streams (``PTConfig.rng``): ``"pcg"``, the counter-based PCG4D hash keyed on
pixel coordinates (ops/rng_pcg.py; the megakernels' stream); ``"threefry"``
(the default), jax.random's threefry2x32 draw ``uniform(fold_in(pass_key,
b), (n, H, W))``; ``"pallas"``, ``uniform_planes(key_to_seed(pass_key) + b,
n, H, W)``, the JAX package's off-TPU stand-in for its hardware stream. The
last two draw image-wide planes through kernel K9 (ops/cuda/rng.py) on a
CUDA scene, and a band draws only its own rows of them, equal to the rows
of the full draw.

Triangles: up to TRI_UNROLL_MAX slots are walked slot by slot; a mesh of any
size comes as a raw BVH, a ClusterSet or instances of one, as in the JAX
package:

- ``bvh=BVH`` (accel/bvh.py): the skip-link traversal (JAX ``_tri_hits``'s
  BVH branch): kernel K8 on a CUDA scene, whatever ``packet`` says (the
  plain traversal must not run on the card), ``accel.bvh.bvh_intersect`` on
  the CPU; then the normal e1 x e2 and the material gathered by the
  original index;
- ``bvh=ClusterSet``: the gather path (JAX ``_tri_hits``): the cluster
  intersector (kernel K6 on a CUDA scene, its plain version on the CPU) with
  visit orders from the mean live origin, then the normal, area and
  material gathered by the hit slot (material from ``scene.tri_mat``);
- ``bvh=InstancedClusters`` (accel/instancing.py): the two-level host path
  (JAX ``_intersect_instanced``): kernel K7 with attributes (its plain
  version on the CPU), the material from the hit's instance (table column
  19), light area 1 for mesh hits;
- ``bvh=FrameClusters`` / ``FrameInstances`` (ops/cuda/cluster.py,
  ops/cuda/instanced.py): the attributes paths of the JAX megakernel
  (``_intersect_clusters``, ``_intersect_instanced`` on KernelInstances):
  the plain sweeps with the frame's visit orders (from the camera). These
  are K4's and K5's oracles; the public entry points refuse them on a CUDA
  scene, where they would run the plain sweeps on the card.

Staged launches (``state_in`` / ``bounce_lo`` / ``bounce_hi`` /
``emit_state``, kernel K5's oracle): a call runs bounces [bounce_lo,
bounce_hi] and returns the 17-plane ray state (``pack_state``; one plane
more with a dispersive scene's chan, and one more with the ray cone's
path length tacc under trilinear filtering), which carries each ray's pixel
coordinates so that any regrouping of rays between calls draws the same
numbers.

Hit UVs (scenes with image textures or UV-space checkers): spheres take
the analytic parametrization (``_sphere_uv``, polynomial inverse trig),
the unrolled slots and a raw BVH interpolate ``scene.tri_uv`` at the hit's
barycentrics, a ClusterSet with UV rows interpolates them (the gather path
from the barycentrics recomputed at the hit point, the attributes path from
the sweep's), instances carry their base table's UVs untransformed, as in
the JAX package. Where shading reads the texture-u tangent (normal maps,
mips: ``PTScene.needs_tan``) the hit also carries ``tan``: spheres the
azimuthal direction (``_sphere_tan``), triangles the world gradient of the
texture u, du1 r1 + du2 r2 from the barycentric gradient rows (the unrolled
slots from the gathered triangle, a ClusterSet from its table rows,
instances rotated into world space as the normal is).

Sampling (``PTConfig``): ``aperture > 0`` turns the pinhole into a thin lens
(two more camera dimensions, a disk of radius ``aperture`` aimed at the
``y = focus_dist`` plane); ``sampler="r2"`` (rng="pcg" and a global pass
index) draws the camera dimensions, and bounce 0's NEE dimensions where NEE
is on, from the R_d sequence (ops/rng_pcg.r2_planes) keyed on the render's
base seed and the global pass.

Not in this slice (each raises NotImplementedError; ROADMAP queue 1 lists
them in order): fog and media, the light tree, mesh lights, the sorted
wavefront (``sort``, with pathtracer/compaction.py); the scene features
pathtracer/scene.py refuses never reach this code.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.bvh import BVH, bvh_intersect
from raytracing_engine_tpu_torch.accel.clusters import CLUSTER, ClusterSet, visit_orders
from raytracing_engine_tpu_torch.accel.instancing import InstancedClusters
from raytracing_engine_tpu_torch.ops import vec3 as v3
from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse as kbvh
from raytracing_engine_tpu_torch.ops.cuda import cluster as kcluster
from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
from raytracing_engine_tpu_torch.ops.cuda import rng as krng
from raytracing_engine_tpu_torch.ops.cuda.cluster import FrameClusters
from raytracing_engine_tpu_torch.ops.cuda.instanced import FrameInstances
from raytracing_engine_tpu_torch.ops.rng import (
    fold_in,
    key_to_seed,
    key_words,
    pcg_base_seed,
    planes_key,
)
from raytracing_engine_tpu_torch.ops.rng_pcg import (
    R2_CAMERA,
    R2_NEE,
    pass_seed,
    r2_planes,
    to_int32,
    uniform_pcg,
    uniform_pcg_coords,
)
from raytracing_engine_tpu_torch.pathtracer import sampler
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig
from raytracing_engine_tpu_torch.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    METAL,
    MIRROR,
    TRI_UNROLL_MAX,
    PTScene,
)

PI = sampler.PI
BIG = float(np.float32(3.4e38))
DEAD_O = 1e18                       # parked-dead-ray origin
INV_SQRT3 = float(np.float32(0.5773502691896258))
BVH_MAX_STEPS = 10_000              # JAX bvh_intersect's per-ray node cap
_MESHES = (BVH, ClusterSet, InstancedClusters, FrameClusters, FrameInstances)

_LATER = "ROADMAP.md queue 1 item 4"
_COMPACTION = "ROADMAP.md queue 1 item 7, pathtracer/compaction.py"
RNGS = ("threefry", "pcg", "pallas")


def _not_yet(what: str, where: str = _LATER):
    raise NotImplementedError(f"{what} is not ported yet ({where})")


def check_supported(cfg: PTConfig, bvh=None, sort=False):
    """Raise NotImplementedError for every static gate this slice lacks."""
    if cfg.rng not in RNGS:
        raise ValueError(f"rng must be one of {RNGS}, got {cfg.rng!r}")
    if cfg.fog_density > 0.0 or cfg.fog_scatter > 0.0:
        _not_yet("fog_density / fog_scatter (fog and media, feature 9)")
    if cfg.light_sampling == "tree":
        _not_yet("light_sampling='tree' (the light tree, feature 12)")
    if cfg.tex_filter not in ("nearest", "bilinear", "trilinear"):
        raise ValueError(f"tex_filter must be nearest, bilinear or trilinear, "
                         f"got {cfg.tex_filter!r}")
    check_mesh(bvh)
    if sort and cfg.rng != "pcg":
        raise ValueError("sort=True requires rng='pcg'")
    if sort:
        _not_yet("sort (the regrouped single-call wavefront)", _COMPACTION)


def check_mesh(bvh):
    """TypeError unless bvh is None or one of the mesh containers."""
    if bvh is not None and not isinstance(bvh, _MESHES):
        raise TypeError(f"bvh must be a BVH (accel.bvh.build_bvh), a ClusterSet "
                        f"(accel.clusters.build_clusters) or an InstancedClusters "
                        f"(accel.instancing.make_instanced_clusters), got {type(bvh).__name__}")


def check_entry(scene: PTScene, bvh):
    """The public entry points take the host containers. The in-kernel
    views (FrameClusters, FrameInstances) run the plain sweeps; they are the
    kernels' oracles, refused on a CUDA scene, where no kernel would run."""
    if isinstance(bvh, (FrameClusters, FrameInstances)) and scene.device.type == "cuda":
        raise TypeError(f"{type(bvh).__name__} is the megakernels' in-kernel view: on a CUDA "
                        "scene pass the ClusterSet or InstancedClusters itself")


def _counts(scene: PTScene):
    """Live (spheres, triangles, lights) as ints (one host read each)."""
    return int(scene.sph_count), int(scene.tri_count), int(scene.light_count)


def _sel(idx, col, n: int):
    """out[lane] = col[idx[lane]] for 0 <= idx < n, else 0 (the JAX
    select chain's value)."""
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, col[:n][idx.clamp(0, n - 1)], torch.zeros((), dtype=col.dtype,
                                                                        device=col.device))


def _camera_rays(cfg: PTConfig, cam_pos, cam_quat, u1, u2, row0=0, col0=0,
                 coords=None, lens=None):
    """Primary rays through pixel + (u1, u2) jitter: (o V3, d V3). With
    lens=(u3, u4) and cfg.aperture > 0 a thin lens: a point of the disk of
    radius aperture on the sensor plane (radius aperture sqrt(u3), angle
    2 pi u4), aimed at the pixel's point on the y = focus_dist camera-space
    plane."""
    if coords is not None:  # explicit global pixel-coordinate planes (py, px)
        iy, ix = coords[0].to(torch.float32), coords[1].to(torch.float32)
    else:
        bh, bw = u1.shape
        ix = torch.arange(bw, dtype=torch.float32, device=u1.device).expand(bh, bw) + col0
        iy = torch.arange(bh, dtype=torch.float32, device=u1.device)[:, None].expand(bh, bw) + row0
    ncx = (v3.div((ix + u1) * 2.0, cfg.width) - 1.0) * cfg.ratio[0]
    ncy = (v3.div((iy + u2) * 2.0, cfg.height) - 1.0) * cfg.ratio[1]
    qx, qy, qz, qw = cam_quat[0], cam_quat[1], cam_quat[2], cam_quat[3]
    vx, vy, vz = ncx, torch.ones_like(ncx), ncy
    lx = lz = None
    if lens is not None and cfg.aperture > 0.0:
        r = cfg.aperture * torch.sqrt(lens[0])
        phi = (2.0 * PI) * lens[1]
        lx, lz = r * torch.cos(phi), r * torch.sin(phi)
        fd = float(np.float32(cfg.focus_dist))
        vx, vy, vz = ncx * fd - lx, torch.zeros_like(ncx) + fd, ncy * fd - lz

    def rot(vx, vy, vz):
        tx = qy * vz - qz * vy + qw * vx
        ty = qz * vx - qx * vz + qw * vy
        tz = qx * vy - qy * vx + qw * vz
        return (vx + 2.0 * (qy * tz - qz * ty),
                vy + 2.0 * (qz * tx - qx * tz),
                vz + 2.0 * (qx * ty - qy * tx))

    dx, dy, dz = rot(vx, vy, vz)
    n = torch.sqrt(dx * dx + dy * dy + dz * dz)
    d = (dx / n, dy / n, dz / n)
    if lx is not None:
        ox, oy, oz = rot(lx, torch.zeros_like(lx), lz)
        o = (cam_pos[0] + ox, cam_pos[1] + oy, cam_pos[2] + oz)
    else:
        o = (cam_pos[0] + dx * 0.0, cam_pos[1] + dy * 0.0, cam_pos[2] + dz * 0.0)
    return o, d


def _sphere_quadratic(scene, k, o, d, t_min):
    """Nearest root > t_min of sphere k along (o, d): (disc, t) planes."""
    cx, cy, cz = scene.sph_pos[k, 0], scene.sph_pos[k, 1], scene.sph_pos[k, 2]
    r = scene.sph_radius[k]
    ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
    b = ocx * d[0] + ocy * d[1] + ocz * d[2]
    c0 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    return disc, torch.where(t0 > t_min, t0, t1)


def _sphere_hits(scene: PTScene, o, d, t_min, n_sph: int):
    """Nearest live sphere: (t, idx) planes; t = BIG and idx = -1 on a miss."""
    best_t = torch.full_like(o[0], BIG)
    best_i = torch.full(o[0].shape, -1, dtype=torch.int64, device=o[0].device)
    for k in range(min(n_sph, scene.sph_pos.shape[0])):
        disc, t = _sphere_quadratic(scene, k, o, d, t_min)
        ok = (disc > 0.0) & (t > t_min) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, k, best_i)
    return best_t, best_i


def _tri_hits_unrolled(scene: PTScene, o, d, t_min, n_tri: int):
    """Nearest live triangle (Möller-Trumbore) over the unrolled slots."""
    best_t = torch.full_like(o[0], BIG)
    best_i = torch.full(o[0].shape, -1, dtype=torch.int64, device=o[0].device)
    for k in range(min(n_tri, scene.tri_v0.shape[0])):
        v0x, v0y, v0z = scene.tri_v0[k, 0], scene.tri_v0[k, 1], scene.tri_v0[k, 2]
        e1x, e1y, e1z = scene.tri_e1[k, 0], scene.tri_e1[k, 1], scene.tri_e1[k, 2]
        e2x, e2y, e2z = scene.tri_e2[k, 0], scene.tri_e2[k, 1], scene.tri_e2[k, 2]
        # pvec = d x e2
        px = d[1] * e2z - d[2] * e2y
        py = d[2] * e2x - d[0] * e2z
        pz = d[0] * e2y - d[1] * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / torch.where(torch.abs(det) < 1e-9, 1.0, det)
        tvx, tvy, tvz = o[0] - v0x, o[1] - v0y, o[2] - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv
        # qvec = tvec x e1
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ((torch.abs(det) >= 1e-9) & (u >= 0.0) & (vv >= 0.0)
              & (u + vv <= 1.0) & (t > t_min) & (t < best_t))
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, k, best_i)
    return best_t, best_i


def _mean_live_origin(o):
    """Mean ray origin over non-parked lanes (visit-order perf hint), (3,)."""
    live = torch.abs(o[0]) < 1e17
    n = torch.clamp_min(live.to(torch.float32).sum(), 1.0)
    return torch.stack([torch.where(live, c, 0.0).sum() / n for c in o])


def _tri_hits_clusters(o, d, t_min, cs: ClusterSet, need_tan: bool = False):
    """(t, original tri index, n V3 unnormalized, 2*area, uv or None, tan or
    None) of the nearest ClusterSet hit, the normal and area gathered by the
    hit slot; t = BIG on a miss. Smooth tables recompute the hit
    barycentrics from the affine rows at the hit point and interpolate the
    shading normals, and UV tables the texture UVs, and with need_tan the
    world texture-u gradient du1 r1 + du2 r2 (JAX wavefront.py:311-347).
    Visit orders (JAX wavefront.py:294-310): row 0 from the mean live
    origin, rows 1+ from the set's order_refs."""
    fc = FrameClusters.at(cs, _mean_live_origin(o))
    t, sidx = kcluster.cluster_intersect(cs, o, d, BIG, t_min=t_min, order=fc.orders[0],
                                         orders=fc.orders, refs=fc.refs)
    safe = torch.clamp_min(sidx, 0).to(torch.int64)
    idx = torch.clamp_min(cs.perm[safe], 0).to(torch.int64)
    n = (cs.tri[0, safe], cs.tri[1, safe], cs.tri[2, safe])
    nlen2 = cs.tri[13, safe]
    tuv = ttan = None
    if cs.smooth:
        base = (safe // CLUSTER) * CLUSTER
        px = o[0] + t * d[0] - cs.tri[20, base]
        py = o[1] + t * d[1] - cs.tri[20, base + 1]
        pz = o[2] + t * d[2] - cs.tri[20, base + 2]
        u = (cs.tri[4, safe] * px + cs.tri[5, safe] * py
             + cs.tri[6, safe] * pz + cs.tri[7, safe])
        v = (cs.tri[8, safe] * px + cs.tri[9, safe] * py
             + cs.tri[10, safe] * pz + cs.tri[11, safe])
        n = tuple(cs.tri[21 + a, safe] + u * cs.tri[24 + a, safe]
                  + v * cs.tri[27 + a, safe] for a in range(3))
        if cs.has_uv:  # rows 32-37: uv0, uv1 - uv0, uv2 - uv0
            tuv = tuple(cs.tri[32 + a, safe] + u * cs.tri[34 + a, safe]
                        + v * cs.tri[36 + a, safe] for a in range(2))
            if need_tan:  # the gradient rows are translation-invariant
                du1, du2 = cs.tri[34, safe], cs.tri[36, safe]
                ttan = tuple(du1 * cs.tri[4 + a, safe] + du2 * cs.tri[8 + a, safe]
                             for a in range(3))
    return torch.where(sidx >= 0, t, BIG), idx, n, nlen2, tuv, ttan


def _tri_uv_gather(scene: PTScene, i_t, p):
    """(uv, tan) of the hit from scene.tri_uv: the barycentrics recomputed
    from the gathered triangle at p, then the corners interpolated, and
    where shading reads it (needs_tan, else None) the world texture-u
    gradient du1 grad(u) + du2 grad(v) (JAX wavefront.py:545-566)."""
    v0g = v3.unstack(scene.tri_v0[i_t])
    e1g = v3.unstack(scene.tri_e1[i_t])
    e2g = v3.unstack(scene.tri_e2[i_t])
    ng = v3.cross(e1g, e2g)
    nn = torch.clamp_min(v3.dot(ng, ng), 1e-30)
    rel = v3.sub(p, v0g)
    gu = v3.scale(v3.cross(e2g, ng), 1.0 / nn)  # gradient of barycentric u
    gv = v3.scale(v3.cross(ng, e1g), 1.0 / nn)  # gradient of barycentric v
    ub = v3.dot(gu, rel)
    vb = v3.dot(gv, rel)
    uv6 = scene.tri_uv[i_t]
    du1 = uv6[..., 2] - uv6[..., 0]
    du2 = uv6[..., 4] - uv6[..., 0]
    uv = (uv6[..., 0] + ub * du1 + vb * du2,
          uv6[..., 1] + ub * (uv6[..., 3] - uv6[..., 1]) + vb * (uv6[..., 5] - uv6[..., 1]))
    if not scene.needs_tan:
        return uv, None
    return uv, v3.add(v3.scale(gu, du1), v3.scale(gv, du2))


def _surface(scene: PTScene, o, d, t_s, i_s, t_t, n_tri, use_tri_mat, tri_area, tuv=None,
             i_t=None, ttan=None):
    """The closest-hit dict from the sphere and triangle candidates
    (the shared tail of JAX _intersect / _intersect_clusters). Where the
    scene's shading reads UVs (needs_uv) it adds ``uv``: on triangle hits
    tuv, else scene.tri_uv at the hit slots i_t (original indices), else
    zeros; the spheres' analytic UVs on sphere hits. Where it reads the
    tangent (needs_tan) it adds ``tan`` likewise: ttan, or the gradient of
    scene.tri_uv at i_t, or zeros; _sphere_tan on sphere hits."""
    use_tri = t_t < t_s
    t = torch.minimum(t_s, t_t)
    hit = t < BIG
    p = v3.add(o, v3.scale(d, t))

    S = scene.sph_pos.shape[0]
    si = torch.clamp_min(i_s, 0)
    sc = tuple(_sel(si, scene.sph_pos[:, c], S) for c in range(3))
    n_sph_v = v3.sub(p, sc)
    n = v3.where(use_tri, n_tri, n_sph_v)
    nlen = torch.clamp_min(v3.length(n), 1e-20)
    n = v3.scale(n, 1.0 / nlen)
    flip = v3.dot(n, d) > 0.0
    n = v3.where(flip, v3.neg(n), n)  # two-sided; `front` = geometric side

    mat_id = torch.where(use_tri, use_tri_mat, _sel(si, scene.sph_mat, S))
    sr = _sel(si, scene.sph_radius, S)
    sph_area = 4.0 * PI * sr * sr
    light_area = torch.where(use_tri, tri_area, sph_area)
    out = dict(t=t, hit=hit, p=p, n=n, mat_id=mat_id, light_area=light_area,
               is_tri=use_tri, front=~flip)
    if scene.needs_uv:
        su, sv = _sphere_uv(n_sph_v)
        if tuv is None and i_t is not None and scene.tri_uv is not None:
            tuv, ttan = _tri_uv_gather(scene, i_t, p)
        if tuv is None:
            tuv = (torch.zeros_like(t), torch.zeros_like(t))
        out["uv"] = (torch.where(use_tri, tuv[0], su), torch.where(use_tri, tuv[1], sv))
    if scene.needs_tan:
        if ttan is None:
            ttan = (torch.zeros_like(t),) * 3
        out["tan"] = v3.where(use_tri, ttan, _sphere_tan(n_sph_v))
    return out


def _intersect(scene: PTScene, o, d, t_min, counts, bvh=None):
    """Closest hit among spheres and triangles (unrolled slots, a raw BVH,
    a ClusterSet by the gather path, FrameClusters by the attributes path,
    or instances: see the module docstring): dict of
    planes t, hit, p, n (unit, facing the ray), mat_id, light_area, is_tri,
    front."""
    n_sph, n_tri, _ = counts
    t_s, i_s = _sphere_hits(scene, o, d, t_min, n_sph)
    if isinstance(bvh, FrameClusters):
        return _intersect_clusters(scene, o, d, t_min, t_s, i_s, bvh)
    if isinstance(bvh, (InstancedClusters, FrameInstances)):
        return _intersect_instanced(scene, o, d, t_min, t_s, i_s, bvh)
    T = scene.tri_v0.shape[0]
    tuv = ttan = None
    if isinstance(bvh, ClusterSet):
        t_t, i_t, n_tri_v, nlen2, tuv, ttan = _tri_hits_clusters(o, d, t_min, bvh,
                                                                 scene.needs_tan)
        tri_mat = scene.tri_mat[i_t]  # gather — T too large to unroll
    elif isinstance(bvh, BVH):
        t_t, i_t, n_tri_v, nlen2 = _tri_hits_bvh(o, d, t_min, bvh)
        tri_mat = scene.tri_mat[i_t]
    else:
        if T > TRI_UNROLL_MAX:
            raise ValueError(f"{T} triangle slots > TRI_UNROLL_MAX={TRI_UNROLL_MAX} without "
                             "a ClusterSet: pass bvh=build_clusters(mesh)")
        t_t, i_t = _tri_hits_unrolled(scene, o, d, t_min, n_tri)
        safe = torch.clamp_min(i_t, 0)
        e1c = tuple(_sel(safe, scene.tri_e1[:, c], T) for c in range(3))
        e2c = tuple(_sel(safe, scene.tri_e2[:, c], T) for c in range(3))
        n_tri_v = v3.cross(e1c, e2c)
        nlen2 = v3.length(n_tri_v)
        tri_mat = _sel(safe, scene.tri_mat, T)
        i_t = safe
    return _surface(scene, o, d, t_s, i_s, t_t, n_tri_v, tri_mat, 0.5 * nlen2, tuv, i_t, ttan)


def _bvh_hits(o, d, t_max, t_min, bvh: BVH, any_hit: bool):
    """(t, reordered idx) of a raw-BVH traversal: kernel K8 on a CUDA
    device, the plain ``bvh_intersect`` on the CPU (the same walk)."""
    if o[0].device.type == "cuda":
        return kbvh.bvh_intersect_packet(kbvh.tables_of(bvh), o, d, t_max, t_min=t_min,
                                         any_hit=any_hit, max_steps=BVH_MAX_STEPS)
    t, idx, _, _ = bvh_intersect(bvh, v3.stack(o), v3.stack(d), t_min=t_min, t_max=t_max,
                                 any_hit=any_hit, max_steps=BVH_MAX_STEPS)
    return t, idx


def _tri_hits_bvh(o, d, t_min, bvh: BVH):
    """(t, original tri index, n V3 unnormalized, |n|) of the nearest raw-BVH
    hit (JAX wavefront.py:348-369); t = BIG on a miss."""
    t, ridx = _bvh_hits(o, d, float("inf"), t_min, bvh, False)
    safe = torch.clamp_min(ridx, 0).to(torch.int64)
    idx = bvh.perm[safe].to(torch.int64)
    n = v3.cross(v3.unstack(bvh.e1[safe]), v3.unstack(bvh.e2[safe]))
    return torch.where(ridx >= 0, t, BIG), idx, n, v3.length(n)


def _intersect_instanced(scene: PTScene, o, d, t_min, t_s, i_s, bvh):
    """The two-level closest hit (JAX wavefront.py:397-488): kernel K7 with
    attributes for an InstancedClusters (the identity orders, as the JAX
    host path), the plain sweep with the frame's orders for FrameInstances.
    Materials come per instance (table column 19); light_area is 1 for mesh
    hits (instanced emissive materials are refused, so it is never read). A UV
    base table gives the hit's UV (object-space data, carried untransformed)
    and, where shading reads it, the tangent in world space."""
    if isinstance(bvh, FrameInstances):
        ic = bvh.ic
        t_w, code, cnx, cny, cnz, *rest = kinst.instanced_cluster_intersect_reference(
            ic.inst_tab, ic.cs, o, d, t_min=t_min, attrs=True, t_max=BIG, iorder=bvh.iorder,
            iorders=bvh.iorders, tan=scene.needs_tan)
    else:
        ic = bvh
        t_w, code, cnx, cny, cnz, *rest = kinst.instanced_cluster_intersect(
            ic.inst_tab, ic.cs, o, d, t_min=t_min, attrs=True, tan=scene.needs_tan)
    inst_id = torch.clamp_min(code, 0).to(torch.int64) // ic.cs.padded_tris
    inst_mat = _sel(inst_id, ic.inst_tab[:, 19], ic.num_instances)
    t_t = torch.where(code >= 0, t_w, BIG)
    return _surface(scene, o, d, t_s, i_s, t_t, (cnx, cny, cnz), inst_mat.to(torch.int32), 1.0,
                    tuple(rest[:2]) or None, ttan=tuple(rest[2:]) or None)


def _intersect_clusters(scene: PTScene, o, d, t_min, t_s, i_s, fc: FrameClusters):
    """The attributes path (JAX wavefront.py:177-271): the plain sweep with
    the frame's orders returns normal, material (tri row 12), area and, on
    a UV table, the hit's UV (the sweep's barycentrics) and, where shading
    reads it, its texture-u tangent."""
    t_t, sidx, cnx, cny, cnz, cmat, carea, *rest = kcluster.cluster_intersect_reference(
        fc.cs, o, d, BIG, t_min=t_min, attrs=True, order=fc.orders[0],
        orders=fc.orders, refs=fc.refs, tan=scene.needs_tan)
    t_t = torch.where(sidx >= 0, t_t, BIG)
    return _surface(scene, o, d, t_s, i_s, t_t, (cnx, cny, cnz), cmat.to(torch.int32), carea,
                    tuple(rest[:2]) or None, ttan=tuple(rest[2:]) or None)


def _occluded(scene: PTScene, o, d, max_t, t_min, counts, bvh=None):
    """Any live sphere or triangle hit in (t_min, max_t): bool plane. With a
    mesh (a raw BVH, a ClusterSet, instances, or a frame view) the mesh
    replaces the unrolled slots."""
    n_sph, n_tri, _ = counts
    blocked = torch.zeros_like(o[0], dtype=torch.bool)
    for k in range(min(n_sph, scene.sph_pos.shape[0])):
        disc, t = _sphere_quadratic(scene, k, o, d, t_min)
        blocked = blocked | ((disc > 0.0) & (t > t_min) & (t < max_t))
    if isinstance(bvh, FrameClusters):
        _, idx = kcluster.cluster_intersect_reference(bvh.cs, o, d, max_t, t_min=t_min,
                                                      any_hit=True, order=bvh.orders[0])
        return blocked | (idx >= 0)
    if isinstance(bvh, ClusterSet):
        order = visit_orders(bvh, _mean_live_origin(o)[None])[0]
        _, idx = kcluster.cluster_intersect(bvh, o, d, max_t, t_min=t_min, any_hit=True,
                                            order=order)
        return blocked | (idx >= 0)
    if isinstance(bvh, FrameInstances):
        _, code = kinst.instanced_cluster_intersect_reference(
            bvh.ic.inst_tab, bvh.ic.cs, o, d, t_min=t_min, any_hit=True, t_max=max_t,
            iorder=bvh.iorder, iorders=bvh.iorders)
        return blocked | (code >= 0)
    if isinstance(bvh, InstancedClusters):
        _, code = kinst.instanced_cluster_intersect(bvh.inst_tab, bvh.cs, o, d, t_min=t_min,
                                                    any_hit=True, t_max=max_t)
        return blocked | (code >= 0)
    if isinstance(bvh, BVH):
        _, idx = _bvh_hits(o, d, max_t, t_min, bvh, True)
        return blocked | (idx >= 0)
    t_t, _ = _tri_hits_unrolled(scene, o, d, t_min, n_tri)
    return blocked | (t_t < max_t)


def _sample_light(scene: PTScene, u_sel, u1, u2, count: int, uniform=False):
    """NEE light sample: (point V3, normal V3, Le V3, pdf_area plane); the
    slot by inclusive power CDF (or uniformly), then a uniform point on it."""
    L = scene.light_kind.shape[0]
    count = max(count, 1)
    if uniform:
        idx = torch.clamp_max((u_sel * count).to(torch.int64), count - 1)
    else:
        idx = torch.zeros(u_sel.shape, dtype=torch.int64, device=u_sel.device)
        for k in range(L - 1):
            idx = idx + (u_sel >= scene.light_cdf[k]).to(torch.int64)

    kind = _sel(idx, scene.light_kind, L)
    prim = _sel(idx, scene.light_prim, L).to(torch.int64)
    area = _sel(idx, scene.light_area, L)
    le = tuple(_sel(idx, scene.light_le[:, c], L) for c in range(3))

    S = scene.sph_pos.shape[0]
    c = tuple(_sel(prim, scene.sph_pos[:, a], S) for a in range(3))
    r = _sel(prim, scene.sph_radius, S)
    p_s, n_s = sampler.sample_sphere_area(u1, u2, c, r)

    Tn = min(scene.tri_v0.shape[0], TRI_UNROLL_MAX)
    v0 = tuple(_sel(prim, scene.tri_v0[:, a], Tn) for a in range(3))
    e1 = tuple(_sel(prim, scene.tri_e1[:, a], Tn) for a in range(3))
    e2 = tuple(_sel(prim, scene.tri_e2[:, a], Tn) for a in range(3))
    su = torch.sqrt(u1)
    b1 = su * (1.0 - u2)
    b2 = su * u2
    p_t = v3.add(v0, v3.add(v3.scale(e1, b1), v3.scale(e2, b2)))
    n_t = v3.cross(e1, e2)
    n_t = v3.scale(n_t, 1.0 / torch.clamp_min(v3.length(n_t), 1e-20))

    is_tri = kind == 1
    point = v3.where(is_tri, p_t, p_s)
    normal = v3.where(is_tri, n_t, n_s)
    if uniform:
        pdf_area = 1.0 / (area * count)
    else:
        pdf_area = _sel(idx, scene.light_pick, L) / torch.clamp_min(area, 1e-20)
    return point, normal, le, pdf_area


def _mat_lookup(scene: PTScene, mat_id):
    M = scene.mat_albedo.shape[0]
    albedo = tuple(_sel(mat_id, scene.mat_albedo[:, c], M) for c in range(3))
    emission = tuple(_sel(mat_id, scene.mat_emission[:, c], M) for c in range(3))
    return albedo, emission, _sel(mat_id, scene.mat_kind, M), _sel(mat_id, scene.mat_ior, M)


def _alphas(scene: PTScene, mat_id):
    """GGX alpha = max(r², 1e-4) of the METAL roughness (Disney remap), and
    alpha_y of roughness_y where the scene has anisotropic metal (else None)
    (JAX wavefront.py:1689-1695)."""
    M = scene.mat_albedo.shape[0]
    rough = _sel(mat_id, scene.mat_rough, M)
    alpha = torch.clamp_min(rough * rough, 1e-4)
    if not scene.has_aniso:
        return alpha, None
    rough2 = _sel(mat_id, scene.mat_rough2, M)
    return alpha, torch.clamp_min(rough2 * rough2, 1e-4)


def _poly_atan2(y, x):
    """atan2 from multiplies, adds and selects (JAX wavefront.py:849):
    octant-reduced Hastings polynomial, |err| < 1e-5 rad, in JAX's order of
    operations (csrc/pt.cuh poly_atan2 repeats it)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    a = torch.minimum(ax, ay) / torch.clamp_min(hi, 1e-30)
    s = a * a
    r = a * (0.9998660 + s * (-0.3302995 + s * (0.1801410 + s * (-0.0851330 + s * 0.0208351))))
    r = torch.where(ay > ax, 0.5 * PI - r, r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def _poly_acos(x):
    """acos by the Hastings square-root form, |err| < 7e-5 rad (JAX
    wavefront.py:865)."""
    ax = torch.clamp(torch.abs(x), 0.0, 1.0)
    r = torch.sqrt(1.0 - ax) * (1.5707288 + ax * (-0.2121144 + ax * (0.0742610
                                                                      - ax * 0.0187293)))
    return torch.where(x < 0.0, PI - r, r)


def _sphere_uv(n_sph):
    """The spheres' analytic UVs from the unnormalized outward normal
    (p - center): u = azimuth / 2π + 0.5, v = polar / π, Z up (JAX
    wavefront.py:874)."""
    ln = torch.clamp_min(v3.length(n_sph), 1e-20)
    u = _poly_atan2(n_sph[1], n_sph[0]) * (0.5 / PI) + 0.5
    v = _poly_acos(torch.clamp(n_sph[2] / ln, -1.0, 1.0)) * (1.0 / PI)
    return u, v


def _sphere_tan(n_sph):
    """The spheres' raw texture-u tangent: the azimuthal direction (-y, x,
    0) of the unnormalized outward normal (JAX wavefront.py:885); it
    degenerates at the poles, where _perturb_normal falls back."""
    return (-n_sph[1], n_sph[0], torch.zeros_like(n_sph[0]))


def _atlas_fetch(atlas, ty, tx):
    """The texel (ty, tx) of a (3K, 128) channel-major table (the atlas, or
    the env map's tables): (c0, c1, c2) planes, channel c from row c K +
    ty; a row outside 0..K-1 reads 0 (JAX wavefront.py:892: its K-row
    select chain). tx lies in 0..127 on every lane that keeps the value;
    it is clamped there for the others, and a NaN coordinate (only such a
    lane can carry one) reads 0, as XLA's float-to-int conversion gives."""
    K = atlas.shape[0] // 3
    ty, tx = (torch.nan_to_num(x, nan=0.0).to(torch.int64) for x in (ty, tx))
    tx = tx.clamp(0, atlas.shape[1] - 1)
    ok = (ty >= 0) & (ty < K)
    row = ty.clamp(0, K - 1)
    zero = torch.zeros((), dtype=atlas.dtype, device=atlas.device)
    return tuple(torch.where(ok, atlas[c * K + row, tx], zero) for c in range(3))


def _env_texel_of(d, K: int):
    """(ty, tx) texel planes (f32, whole numbers) of direction d in the
    equirect map, the inverse of _sample_env's mapping (JAX
    wavefront.py:962)."""
    u = _poly_atan2(d[1], d[0]) * (0.5 / PI) + 0.5
    v = _poly_acos(torch.clamp(d[2], -1.0, 1.0)) * (1.0 / PI)
    tx = torch.clamp(torch.floor(u * 128.0), 0.0, 127.0)
    ty = torch.clamp(torch.floor(v * float(K)), 0.0, float(K - 1))
    return ty, tx


def _env_pdf_w(scene: PTScene, ty, tx, sin_t):
    """Solid-angle pdf of the env NEE sampler for a direction in texel
    (ty, tx) with polar sine sin_t: p_sel N / (2π² sinθ) (JAX
    wavefront.py:974)."""
    K = scene.env_img.shape[0] // 3
    psel, _, _ = _atlas_fetch(scene.env_smp, ty, tx)
    return psel * (K * 128.0) / torch.clamp_min(2.0 * PI * PI * sin_t, 1e-8)


def _sample_env(scene: PTScene, s, j1, j2):
    """Alias-sample an env-map texel with the selection uniform s and
    jitter inside it by (j1, j2): (dir V3, pdf_w, le V3) (JAX
    wavefront.py:985). The divisions by 128 and K divide by device
    tensors, as the kernel divides (ops/vec3.div)."""
    K = scene.env_img.shape[0] // 3
    N = float(K * 128)
    x = s * N
    j = torch.clamp(torch.floor(x), 0.0, N - 1.0)
    f = x - j
    ty0 = torch.floor(v3.div(j, 128.0))
    tx0 = j - ty0 * 128.0
    _, ap, ai = _atlas_fetch(scene.env_smp, ty0, tx0)
    t = torch.where(f < ap, j, ai)
    ty = torch.floor(v3.div(t, 128.0))
    tx = t - ty * 128.0
    u = v3.div(tx + j1, 128.0)
    v = v3.div(ty + j2, float(K))
    theta = v * PI
    phi = (u - 0.5) * (2.0 * PI)
    sin_t = torch.sin(theta)
    d = (sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta))
    psel, _, _ = _atlas_fetch(scene.env_smp, ty, tx)
    le = _atlas_fetch(scene.env_img, ty, tx)
    pdf = psel * N / torch.clamp_min(2.0 * PI * PI * sin_t, 1e-8)
    return d, pdf, le


def _rect_texel(x0, y0, tw, th, uv, s):
    """Scale-tiled UV -> (ty, tx) texel planes (f32, whole numbers) inside
    the [x0, y0, tw, th] rect, wrap addressing, nearest texel (JAX
    wavefront.py:1019)."""
    fu = uv[0] * s
    fv = uv[1] * s
    fu = fu - torch.floor(fu)  # wrap (tile) addressing
    fv = fv - torch.floor(fv)
    # max(..., 0) also guards untextured lanes (tw = 0: clamp hi = -1)
    tx = torch.clamp_min(x0 + torch.clamp(torch.floor(fu * tw), torch.zeros_like(tw), tw - 1.0),
                         0.0)
    ty = torch.clamp_min(y0 + torch.clamp(torch.floor(fv * th), torch.zeros_like(th), th - 1.0),
                         0.0)
    return ty, tx


def _sample_rect(atlas, x0, y0, tw, th, uv, s, bilinear=False):
    """The [x0, y0, tw, th] atlas rect at scale-tiled UV (JAX
    wavefront.py:1037): one texel (nearest), or four rect-clamped corners
    lerped at texel centres (i + 0.5) / w (bilinear)."""
    if not bilinear:
        ty, tx = _rect_texel(x0, y0, tw, th, uv, s)
        return _atlas_fetch(atlas, ty, tx)
    fu = uv[0] * s
    fv = uv[1] * s
    fu = fu - torch.floor(fu)  # wrap (tile) addressing
    fv = fv - torch.floor(fv)
    fx = fu * tw - 0.5
    fy = fv * th - 0.5
    xf = torch.floor(fx)
    yf = torch.floor(fy)
    wx = fx - xf
    wy = fy - yf
    # clamp the corners to the rect (no bleeding across rects at edges)
    zero = torch.zeros_like(tw)
    xa = torch.clamp(xf, zero, tw - 1.0)
    xb = torch.clamp(xf + 1.0, zero, tw - 1.0)
    ya = torch.clamp(yf, zero, th - 1.0)
    yb = torch.clamp(yf + 1.0, zero, th - 1.0)
    c00 = _atlas_fetch(atlas, torch.clamp_min(y0 + ya, 0.0), torch.clamp_min(x0 + xa, 0.0))
    c10 = _atlas_fetch(atlas, torch.clamp_min(y0 + ya, 0.0), torch.clamp_min(x0 + xb, 0.0))
    c01 = _atlas_fetch(atlas, torch.clamp_min(y0 + yb, 0.0), torch.clamp_min(x0 + xa, 0.0))
    c11 = _atlas_fetch(atlas, torch.clamp_min(y0 + yb, 0.0), torch.clamp_min(x0 + xb, 0.0))
    return tuple((c00[c] * (1.0 - wx) + c10[c] * wx) * (1.0 - wy)
                 + (c01[c] * (1.0 - wx) + c11[c] * wx) * wy for c in range(3))


def _mip_lod_footprint(cfg: PTConfig, scene: PTScene, isect, d, tacc):
    """The ray cone's footprint at the hit in UV units (JAX
    wavefront.py:1074-1110): width tacc * 2 fov / width over sqrt(|d.n|),
    times the UV density, on a sphere the larger of the azimuthal 1 / (2π
    |tan|) and the polar 1 / (π r) (r from the carried light area 4π r²),
    on a triangle |tan|, the texture-u gradient alone (the reference's
    approximation: the v-gradient is left out)."""
    tl = v3.length(isect["tan"])
    sph_r = torch.sqrt(isect["light_area"] * (0.25 / PI))
    sph_dens = torch.maximum(1.0 / (2.0 * PI * torch.clamp_min(tl, 1e-8)),
                             1.0 / (PI * torch.clamp_min(sph_r, 1e-8)))
    inv_du = torch.where(isect["is_tri"], tl, sph_dens)
    alpha = 2.0 * cfg.fov / cfg.width
    cosw = torch.abs(v3.dot(d, isect["n"]))
    width = tacc * alpha / torch.sqrt(torch.clamp_min(cosw, 1e-2))
    return width * inv_du


def _sample_rect_tri(scene: PTScene, mat_id, uv, s, fp_uv):
    """Trilinear sample of a material's albedo mip chain (JAX
    wavefront.py:1111-1148): the level lod = log2 of the footprint in
    level-0 texels, clamped to the chain; the two bracketing levels' rects
    (mat_tex_mips) sampled bilinearly and lerped by lod's fraction."""
    M = scene.mat_albedo.shape[0]
    L = scene.n_mip_levels
    mips = scene.mat_tex_mips
    tw0 = _sel(mat_id, mips[:, 2], M)
    texels = fp_uv * s * torch.clamp_min(tw0, 1.0)
    lod = torch.log2(torch.clamp(texels, 1.0, float(1 << (L - 1))))
    l0 = torch.floor(lod)
    fr = lod - l0

    def level_rect(lev):
        rect = [torch.zeros_like(lod) for _ in range(4)]
        for lv in range(L):
            m = lev == lv
            for k in range(4):
                rect[k] = torch.where(m, _sel(mat_id, mips[:, 4 * lv + k], M), rect[k])
        return rect

    ca = _sample_rect(scene.tex_atlas, *level_rect(l0), uv, s, bilinear=True)
    cb = _sample_rect(scene.tex_atlas, *level_rect(torch.clamp_max(l0 + 1.0, float(L - 1))),
                      uv, s, bilinear=True)
    return tuple(ca[c] * (1.0 - fr) + cb[c] * fr for c in range(3))


def _perturb_normal(scene: PTScene, mat_id, n, tan, uv, bilinear=False):
    """Tangent-space normal mapping (JAX wavefront.py:1151-1190): the map's
    texel decoded as 2 rgb - 1 and turned into world space by the frame (T,
    n x T, n), T the tangent made orthogonal to the unit ray-facing normal n
    (a degenerate one falls back to z x n, or x x n near ±z), normalized.
    A decoded texel of length <= 1e-6 keeps n, and so does a material
    without a map (rect w = 0)."""
    M = scene.mat_albedo.shape[0]
    x0, y0, tw, th = (_sel(mat_id, scene.mat_nrm_rect[:, k], M) for k in range(4))
    s = _sel(mat_id, scene.mat_nrm_scale, M)
    rgb = _sample_rect(scene.tex_atlas, x0, y0, tw, th, uv, s, bilinear=bilinear)
    ntx = 2.0 * rgb[0] - 1.0
    nty = 2.0 * rgb[1] - 1.0
    ntz = 2.0 * rgb[2] - 1.0
    tp = v3.sub(tan, v3.scale(n, v3.dot(n, tan)))
    zero, one = torch.zeros_like(n[0]), torch.ones_like(n[0])
    fb = v3.where(torch.abs(n[2]) < 0.9, v3.cross((zero, zero, one), n),
                  v3.cross((one, zero, zero), n))
    tp = v3.where(v3.dot(tp, tp) > 1e-12, tp, fb)
    t = v3.scale(tp, 1.0 / torch.clamp_min(v3.length(tp), 1e-20))
    b = v3.cross(n, t)
    np_ = tuple(ntx * t[a] + nty * b[a] + ntz * n[a] for a in range(3))
    ln = v3.length(np_)
    np_ = v3.where(ln > 1e-6, v3.scale(np_, 1.0 / torch.clamp_min(ln, 1e-20)), n)
    return v3.where(tw > 0.0, np_, n)


def _textured_albedo(scene: PTScene, mat_id, albedo, p, uv=None, bilinear=False, fp_uv=None):
    """Checkers and image textures (JAX wavefront.py:1193-1225): checker
    cells of size 1/scale alternate the albedo and mat_albedo2 (scale 0 is
    flat), in world space or, for mat_tex_space 1, in UV space; the parity
    is a floored modulo (negative cells included). Image-textured materials
    (rect w > 0) then sample the atlas at the scale-tiled hit UV, trilinearly
    across the mip chain where a ray-cone footprint fp_uv is given (a
    tex_mips scene under tex_filter "trilinear")."""
    M = scene.mat_albedo.shape[0]
    s = _sel(mat_id, scene.mat_tex_scale, M)
    a2 = tuple(_sel(mat_id, scene.mat_albedo2[:, c], M) for c in range(3))
    cells = torch.floor(p[0] * s) + torch.floor(p[1] * s) + torch.floor(p[2] * s)
    if uv is not None and scene.mat_tex_space is not None:
        space = _sel(mat_id, scene.mat_tex_space, M)
        cells_uv = torch.floor(uv[0] * s) + torch.floor(uv[1] * s)
        cells = torch.where(space > 0.5, cells_uv, cells)
    odd = torch.remainder(cells, 2.0) >= 1.0
    out = v3.where((s > 0.0) & odd, a2, albedo)
    if scene.mat_tex_rect is not None and uv is not None:
        x0, y0, tw, th = (_sel(mat_id, scene.mat_tex_rect[:, k], M) for k in range(4))
        if fp_uv is not None and scene.has_mips:
            rgb = _sample_rect_tri(scene, mat_id, uv, s, fp_uv)
        else:
            rgb = _sample_rect(scene.tex_atlas, x0, y0, tw, th, uv, s, bilinear=bilinear)
        out = v3.where(tw > 0.0, rgb, out)
    return out


def _sky(scene: PTScene, d):
    """The gradient sky in direction d: bottom + (top - bottom) * 0.5 (d.z + 1)."""
    tz = 0.5 * (d[2] + 1.0)
    env = scene.env
    return tuple(env[0, c] + (env[1, c] - env[0, c]) * tz for c in range(3))


# --- the staged ray state (JAX wavefront.py:1321-1370) ----------------------
_STATE_V3 = ("o", "d", "thr", "rad")
_STATE_SCALAR = ("alive", "prev_did_nee", "prev_pdf")
# o, d, thr, rad (3 each), alive, prev_did_nee, prev_pdf, px, py; a
# dispersive scene adds chan, the committed color channel (-1: none yet), and
# trilinear filtering tacc, the ray cone's path length so far
STATE_PLANES = 17


def has_tacc(scene: PTScene, cfg: PTConfig | None) -> bool:
    """The ray state carries tacc: a tex_mips scene under "trilinear"."""
    return cfg is not None and scene.has_mips and cfg.tex_filter == "trilinear"


def state_plane_count(scene: PTScene | None = None, cfg: PTConfig | None = None) -> int:
    """Number of f32 planes in a packed inter-launch ray state (JAX
    wavefront.py:1325-1329): 17, one more with the chan plane of a
    dispersive scene, and one more with tacc (has_tacc)."""
    if scene is None:
        return STATE_PLANES
    return STATE_PLANES + (1 if scene.has_dispersion else 0) + (1 if has_tacc(scene, cfg) else 0)


def pack_state(st) -> torch.Tensor:
    """A state dict as one (17 to 19, ...) f32 tensor: the transport format
    between per-bounce launches. Masks ride as 0/1, px/py as f32 (exact
    below 2^24), then chan and tacc where the state has them."""
    planes = []
    for k in _STATE_V3:
        planes.extend(st[k])
    for k in _STATE_SCALAR:
        planes.append(st[k].to(torch.float32))
    planes.append(st["px"].to(torch.float32))
    planes.append(st["py"].to(torch.float32))
    if "chan" in st:
        planes.append(st["chan"])
    if "tacc" in st:
        planes.append(st["tacc"])
    return torch.stack(planes)


def unpack_state(arr, has_chan: bool = False, has_tacc: bool = False):
    """Inverse of pack_state."""
    st = {}
    i = 0
    for k in _STATE_V3:
        st[k] = (arr[i], arr[i + 1], arr[i + 2])
        i += 3
    st["alive"] = arr[i] != 0.0
    st["prev_did_nee"] = arr[i + 1] != 0.0
    st["prev_pdf"] = arr[i + 2]
    st["px"] = arr[i + 3].to(torch.int64)
    st["py"] = arr[i + 4].to(torch.int64)
    i += 5
    if has_chan:
        st["chan"] = arr[i]
        i += 1
    if has_tacc:
        st["tacc"] = arr[i]
    return st


def _bounce(cfg: PTConfig, scene: PTScene, st, b: int, draw, counts, bvh):
    """Bounce b of every ray of the state dict: returns the next state. The
    material features (metal, anisotropy, checkers, image textures, normal
    maps, mips, dispersion, rough glass, the sky, the env map) are static
    gates: a scene without one runs the program it ran before."""
    n_light = counts[2]
    st = dict(st)
    thr, rad = st["thr"], st["rad"]
    alive, o, d = st["alive"], st["o"], st["d"]
    nu = 6 if cfg.rr_start > 0 else 5  # [5] = roulette coin
    u = draw(b + 1, nu)
    zero = torch.zeros_like(st["prev_pdf"])
    nrays = st["nrays"] + alive.sum()

    isect = _intersect(scene, o, d, cfg.t_min, counts, bvh)
    hit = isect["hit"] & alive
    albedo, emission, kind, ior = _mat_lookup(scene, isect["mat_id"])
    n, p = isect["n"], isect["p"]
    metal = scene.has_metal
    if metal:
        alpha, alpha_y = _alphas(scene, isect["mat_id"])
    if scene.has_normal_map:
        # every later step reads the perturbed shading normal; the map has no
        # mip chain and is sampled bilinearly under trilinear filtering
        n = _perturb_normal(scene, isect["mat_id"], n, isect["tan"], isect["uv"],
                            bilinear=cfg.tex_filter in ("bilinear", "trilinear"))
    fp_uv = None
    if has_tacc(scene, cfg):
        # the cone grows by this segment before the hit is shaded
        st["tacc"] = st["tacc"] + torch.where(hit, isect["t"], 0.0)
        fp_uv = _mip_lod_footprint(cfg, scene, isect, d, st["tacc"])
    if scene.has_texture:
        albedo = _textured_albedo(scene, isect["mat_id"], albedo, p, uv=isect.get("uv"),
                                  bilinear=cfg.tex_filter in ("bilinear", "trilinear"),
                                  fp_uv=fp_uv)
    if metal and scene.has_aniso:
        # the anisotropy axes live in the per-normal frame
        onb_t, onb_s = sampler.build_onb(n)

    # --- emission (MIS vs NEE of the previous vertex) ------------------
    emissive = (emission[0] > 0.0) | (emission[1] > 0.0) | (emission[2] > 0.0)
    cos_l = torch.abs(v3.dot(n, d))
    if cfg.light_sampling == "uniform":
        sel_density = 1.0 / torch.clamp_min(isect["light_area"] * max(n_light, 1), 1e-20)
    else:
        lum_e = 0.2126 * emission[0] + 0.7152 * emission[1] + 0.0722 * emission[2]
        sel_density = lum_e / torch.clamp_min(scene.light_total_power, 1e-20)
    env_map = scene.has_env_map
    if env_map and cfg.use_nee:
        # the light table's branch runs with probability 1 - env_pick: the
        # hit-side MIS density carries the same marginal
        sel_density = sel_density * (1.0 - scene.env_pick)
    pdf_light_w = sel_density * (isect["t"] * isect["t"]) / torch.clamp_min(cos_l, 1e-6)
    w_b = torch.where(st["prev_did_nee"], sampler.power_heuristic(st["prev_pdf"], pdf_light_w),
                      1.0)
    gate = torch.where(hit & emissive, w_b, 0.0)
    rad = v3.add(rad, v3.mul(thr, v3.scale(emission, gate)))

    if scene.has_env:
        # escaped rays read the sky at full weight (JAX wavefront.py:1822-1832);
        # the lane then dies at the cont gate, so this adds once
        esc = torch.where(alive & ~isect["hit"], 1.0, 0.0)
        rad = v3.add(rad, v3.mul(thr, v3.scale(_sky(scene, d), esc)))

    if env_map:
        # escaped rays read the map's texel of their direction, MIS-weighted
        # against the previous vertex's env NEE (JAX wavefront.py:1799-1819)
        esc = torch.where(alive & ~isect["hit"], 1.0, 0.0)
        e_ty, e_tx = _env_texel_of(d, scene.env_img.shape[0] // 3)
        e_rad = _atlas_fetch(scene.env_img, e_ty, e_tx)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - d[2] * d[2], 1e-12))
        pdf_env_h = _env_pdf_w(scene, e_ty, e_tx, sin_t)
        w_esc = torch.where(st["prev_did_nee"] & cfg.use_nee,
                            sampler.power_heuristic(st["prev_pdf"], scene.env_pick * pdf_env_h),
                            1.0)
        rad = v3.add(rad, v3.mul(thr, v3.scale(e_rad, esc * w_esc)))

    # --- NEE ------------------------------------------------------------
    if cfg.use_nee:
        u_sel = u[2]
        if env_map:
            # one coin splits the env map and the light table; the selection
            # uniform is rescaled into the chosen branch (JAX
            # wavefront.py:1838-1846)
            pick = scene.env_pick
            sel_env = u[2] < pick
            u_sel = torch.clamp((u[2] - pick) / torch.clamp_min(1.0 - pick, 1e-6),
                                0.0, 1.0 - 1e-7)
        lp, ln, le, pdf_area = _sample_light(scene, u_sel, u[3], u[4], n_light,
                                             uniform=cfg.light_sampling == "uniform")
        to_l = v3.sub(lp, p)
        dist = v3.length(to_l)
        wi = v3.scale(to_l, 1.0 / torch.clamp_min(dist, 1e-20))
        cos_ll = torch.abs(v3.dot(ln, wi))
        light_ok = (cos_ll > 1e-6) & (dist > cfg.eps) & (n_light > 0)
        if env_map:
            e_d, e_pdf, e_le = _sample_env(
                scene, torch.clamp(u[2] / torch.clamp_min(pick, 1e-6), 0.0, 1.0 - 1e-7),
                u[3], u[4])
            wi = v3.where(sel_env, e_d, wi)
            le = v3.where(sel_env, e_le, le)
            # env lanes have no light surface: the shadow ray is unbounded
            light_ok = sel_env | light_ok
            dist = torch.where(sel_env, 1e4, dist)
        cos_s = v3.dot(n, wi)
        nee_kind = kind == DIFFUSE
        if metal:  # GGX surfaces are NEE-sampled too
            nee_kind = nee_kind | (kind == METAL)
        cand = hit & nee_kind & light_ok & (cos_s > 0.0)
        nrays = nrays + cand.sum()
        # park non-candidate shadow rays far away; `vis` is cand-gated
        dead_o = (zero + DEAD_O,) * 3
        dead_d = (zero + INV_SQRT3,) * 3
        sh_o = v3.where(cand, v3.add(p, v3.scale(n, cfg.eps)), dead_o)
        sh_d = v3.where(cand, wi, dead_d)
        max_t = dist * (1.0 - 1e-3)
        if env_map:
            max_t = torch.where(sel_env, BIG, max_t)
        vis = cand & ~_occluded(scene, sh_o, sh_d, max_t, cfg.t_min, counts, bvh)
        pdf_w = pdf_area * (dist * dist) / torch.clamp_min(cos_ll, 1e-6)
        if env_map:
            # each branch's pdf carries its selection probability
            pdf_w = torch.where(sel_env, pick * e_pdf, (1.0 - pick) * pdf_w)
        if metal:
            # f = albedo/π (diffuse) or the GGX BRDF (metal); the MIS
            # counter-pdf follows (JAX wavefront.py:1904-1915)
            if scene.has_aniso:
                f_m, pdf_m = sampler.ggx_eval_aniso(n, onb_t, onb_s, v3.neg(d), wi, albedo,
                                                    alpha, alpha_y)
            else:
                f_m, pdf_m = sampler.ggx_eval(n, v3.neg(d), wi, albedo, alpha)
            is_met = kind == METAL
            pdf_b = torch.where(is_met, pdf_m, v3.div(cos_s, PI))
            f_nee = v3.where(is_met, f_m, v3.scale(albedo, 1.0 / PI))
            w_nee = sampler.power_heuristic(pdf_w, pdf_b)
            scale = torch.where(vis, cos_s / torch.clamp_min(pdf_w, 1e-20) * w_nee, 0.0)
            rad = v3.add(rad, v3.mul(v3.mul(thr, f_nee), v3.scale(le, scale)))
        else:
            w_nee = sampler.power_heuristic(pdf_w, v3.div(cos_s, PI))
            scale = torch.where(
                vis, v3.div(cos_s / torch.clamp_min(pdf_w, 1e-20) * w_nee, PI), 0.0)
            rad = v3.add(rad, v3.mul(v3.mul(thr, albedo), v3.scale(le, scale)))

    # --- scatter --------------------------------------------------------
    diff_d, pdf_cos = sampler.cosine_hemisphere(u[0], u[1], n)
    mirr_d = v3.sub(d, v3.scale(n, 2.0 * v3.dot(d, n)))
    new_d = v3.where(kind == MIRROR, mirr_d, diff_d)
    new_o = v3.add(p, v3.scale(n, cfg.eps))
    if scene.has_dielectric:
        if scene.has_dispersion:
            # the first dispersive glass hit commits the lane to one channel
            # (3x one-hot throughput) and shifts its ior; u[1] is free on
            # glass lanes (JAX wavefront.py:1948-1965)
            dispm = _sel(isect["mat_id"], scene.mat_dispersion, scene.mat_albedo.shape[0])
            pick = hit & (kind == DIELECTRIC) & (dispm > 0.0) & (st["chan"] < 0.0)
            c = torch.clamp(torch.floor(u[1] * 3.0), 0.0, 2.0)
            chan = torch.where(pick, c, st["chan"])
            thr = tuple(thr[k] * torch.where(pick, 3.0 * (chan == float(k)).to(torch.float32),
                                             1.0) for k in range(3))
            st["chan"] = chan
            shift = torch.where(chan >= 0.0, (chan - 1.0) * 0.5, 0.0)
            ior = ior + dispm * shift
        # exact unpolarized Fresnel split between reflection and Snell
        # refraction; u[0] is the R/T coin (glass lanes draw no
        # hemisphere sample)
        eta = torch.where(isect["front"], 1.0 / ior, ior)
        cosi = -v3.dot(d, n)  # n faces the ray: >= 0
        kk = 1.0 - eta * eta * (1.0 - cosi * cosi)
        cost = torch.sqrt(torch.clamp_min(kk, 0.0))
        rs = (eta * cosi - cost) / torch.clamp_min(eta * cosi + cost, 1e-20)
        rp = (eta * cost - cosi) / torch.clamp_min(eta * cost + cosi, 1e-20)
        refl_p = torch.where(kk <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))
        refr_d = v3.add(v3.scale(d, eta), v3.scale(n, eta * cosi - cost))
        reflect = u[0] < refl_p
        is_diel = kind == DIELECTRIC
        if scene.has_rough_dielectric:
            # GGX rough glass (Walter 2007): a half-vector from u[3], u[4]
            # (free on glass lanes), the same Fresnel coin about it, and
            # the weight |d·h| G / (cos_o cos_h); a sample on the wrong
            # side weighs 0 (JAX wavefront.py:1980-2030)
            h_d, cos_hd = sampler.sample_ggx_h(u[3], u[4], n, alpha)
            cosi_h = -v3.dot(d, h_d)
            kk_h = 1.0 - eta * eta * (1.0 - cosi_h * cosi_h)
            cost_h = torch.sqrt(torch.clamp_min(kk_h, 0.0))
            rs_h = (eta * cosi_h - cost_h) / torch.clamp_min(eta * cosi_h + cost_h, 1e-20)
            rp_h = (eta * cost_h - cosi_h) / torch.clamp_min(eta * cost_h + cosi_h, 1e-20)
            reflp_h = torch.where(kk_h <= 0.0, 1.0, 0.5 * (rs_h * rs_h + rp_h * rp_h))
            refl_h = u[0] < reflp_h
            mirr_h = sampler.reflect(d, h_d)
            refr_h = v3.add(v3.scale(d, eta), v3.scale(h_d, eta * cosi_h - cost_h))
            d_r = v3.where(refl_h, mirr_h, refr_h)
            cos_i_r = v3.dot(d_r, n)
            g_r = sampler.ggx_smith_g1(cosi, alpha) * sampler.ggx_smith_g1(torch.abs(cos_i_r),
                                                                          alpha)
            w_g = (torch.abs(cosi_h) * g_r
                   / torch.clamp_min(cosi * torch.clamp_min(cos_hd, 1e-6), 1e-6))
            ok_r = (cosi_h > 0.0) & ((refl_h & (cos_i_r > 0.0)) | (~refl_h & (cos_i_r < 0.0)))
            w_g = torch.where(ok_r, w_g, 0.0)
            rough_d = _sel(isect["mat_id"], scene.mat_rough, scene.mat_albedo.shape[0])
            is_rough_d = is_diel & (rough_d > 0.0)
            reflect = (is_rough_d & refl_h) | (~is_rough_d & reflect)
            diel_w = torch.where(is_rough_d, w_g, 1.0)
            mirr_d = v3.where(is_rough_d, d_r, mirr_d)  # the reflect slot
            refr_d = v3.where(is_rough_d, d_r, refr_d)  # the refract slot
        new_d = v3.where(is_diel, v3.where(reflect, mirr_d, refr_d), new_d)
        # refracted rays continue THROUGH the surface: offset inward
        off = torch.where(is_diel & ~reflect, -cfg.eps, cfg.eps)
        new_o = v3.add(p, v3.scale(n, off))
    if metal:
        # GGX conductor: an NDF half-vector from u[0], u[1] (free on metal
        # lanes), reflect, weight f·cos/pdf; an under-surface sample gets
        # f = pdf = 0 and dies at the cont gate (JAX wavefront.py:2035-2065)
        if scene.has_aniso:
            h_vec = sampler.sample_ggx_h_aniso(u[0], u[1], onb_t, onb_s, n, alpha, alpha_y)
            met_d = sampler.reflect(d, h_vec)
            f_s, pdf_s = sampler.ggx_eval_aniso(n, onb_t, onb_s, v3.neg(d), met_d, albedo,
                                                alpha, alpha_y)
        else:
            h_vec, _ = sampler.sample_ggx_h(u[0], u[1], n, alpha)
            met_d = sampler.reflect(d, h_vec)
            f_s, pdf_s = sampler.ggx_eval(n, v3.neg(d), met_d, albedo, alpha)
        w_met = v3.scale(f_s, torch.where(
            pdf_s > 0.0, v3.dot(n, met_d) / torch.clamp_min(pdf_s, 1e-12), 0.0))
        is_metal = kind == METAL
        new_d = v3.where(is_metal, met_d, new_d)
        new_thr = v3.mul(thr, v3.where(is_metal, w_met, albedo))
        pdf_bsdf = torch.where(is_metal, pdf_s, pdf_cos)
    else:
        new_thr = v3.mul(thr, albedo)
        pdf_bsdf = pdf_cos
    if scene.has_rough_dielectric:  # the Walter weight on rough-glass lanes
        new_thr = v3.scale(new_thr, diel_w)
    thr_max = torch.maximum(new_thr[0], torch.maximum(new_thr[1], new_thr[2]))
    cont = hit & (thr_max > 0.0)
    if cfg.rr_start > 0 and b >= cfg.rr_start:
        # Russian roulette: survive w.p. p_c, divide throughput by p_c
        p_c = torch.clamp(thr_max, 0.05, 1.0)
        cont = cont & (u[5] < p_c)
        new_thr = v3.scale(new_thr, 1.0 / p_c)
    # park dead rays far away with an all-positive direction: every slab
    # test then fails, and the regroup keys send them last
    st["thr"] = v3.where(cont, new_thr, (zero, zero, zero))
    st["o"] = v3.where(cont, new_o, (zero + DEAD_O,) * 3)
    st["d"] = v3.where(cont, new_d, (zero + INV_SQRT3,) * 3)
    st["alive"] = cont
    nee_kinds = kind == DIFFUSE
    if metal:
        nee_kinds = nee_kinds | (kind == METAL)
    # the env map is an NEE target too: a vertex did NEE with no slot light
    st["prev_did_nee"] = hit & nee_kinds & (env_map or n_light > 0) & cfg.use_nee
    st["prev_pdf"] = pdf_bsdf
    st["rad"] = rad
    st["nrays"] = nrays
    return st


def _draws(cfg: PTConfig, key, h: int, w: int, row0, band_h, col0, band_w, device):
    """draw(ctr, n) of a threefry or pallas pass under the pass key: the
    (n, h, w) planes of the window from the image-wide draw of counter ctr,
    which covers rows row0 .. and columns col0 .. only where band_h and
    band_w are given (JAX wavefront.py:1488-1505)."""
    words = key_words(key)
    r0 = row0 if band_h is not None else 0
    c0 = col0 if band_w is not None else 0
    if cfg.rng == "pallas":
        seed = key_to_seed(words)

        def key_of(ctr):
            return planes_key(to_int32(seed + ctr))
    else:
        def key_of(ctr):
            return fold_in(words, ctr)

    def draw(ctr, n):
        u = krng.uniform_key(key_of(ctr), n, cfg.height, cfg.width, row0=r0, band_h=h,
                             device=device)
        return u if w == cfg.width else u[:, :, c0:c0 + w]

    return draw


def _trace_core(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, seed0=None,
                row0=0, band_h=None, col0=0, band_w=None, pix=None, bvh=None,
                sort=False, state_in=None, bounce_lo=0, bounce_hi=None,
                emit_state=False, key=None, gpass=None, seed_base=None):
    """One sample per pixel of the window at (row0, col0): (rad V3 planes,
    nrays int64 tensor). The pass's stream: at rng="pcg" the int32 seed0
    (else key_to_seed(key)); at "threefry" and "pallas" the pass key. pix:
    optional (py, px) GLOBAL pixel-coordinate planes that replace the
    window's. bvh: None, a BVH, a ClusterSet, an InstancedClusters or a
    frame view (see the module docstring).

    Staged launches: state_in (a state dict from unpack_state) replaces the
    camera rays; bounces bounce_lo .. bounce_hi (default cfg.max_bounces)
    run; emit_state returns the state dict (rad and nrays inside) instead of
    (rad, nrays). The state carries px/py, and every draw of a staged call
    is keyed on them (rng="pcg" only, as in the JAX package).

    gpass, seed_base: the pass's global index and the render's base seed
    (default seed0), which key the R_d draws of sampler="r2"."""
    check_supported(cfg, bvh=bvh, sort=sort)
    if cfg.tex_filter == "trilinear" and not scene.has_mips:
        raise ValueError("tex_filter='trilinear' needs packed mip chains — build the scene "
                         "with build_pt_scene(tex_mips=True)")
    if bounce_hi is None:
        bounce_hi = cfg.max_bounces
    if bounce_lo > 0 and state_in is None:
        raise ValueError("bounce_lo > 0 needs state_in, the state of bounce_lo - 1")
    staged = emit_state or state_in is not None
    if pix is not None and cfg.rng != "pcg":
        raise ValueError("pix coordinate planes require rng='pcg'")
    if staged and cfg.rng != "pcg":
        raise ValueError("state_in/emit_state staging requires rng='pcg'")
    h, w = (band_h or cfg.height), (band_w or cfg.width)
    device = scene.device
    counts = _counts(scene)
    window_draw = None
    if cfg.rng == "pcg" and seed0 is None:
        seed0 = key_to_seed(0 if key is None else key)
    elif cfg.rng != "pcg":
        if key is None:
            raise ValueError(f"rng={cfg.rng!r} draws from the pass key: pass key=")
        window_draw = _draws(cfg, key, h, w, row0, band_h, col0, band_w, device)

    use_r2 = cfg.sampler == "r2"
    if use_r2:
        if cfg.rng != "pcg" or gpass is None:
            raise ValueError("sampler='r2' needs rng='pcg' and a global pass index "
                             "(render via render_pt_fast / render_pt_mega)")
        if pix is not None:
            r2py, r2px = pix[0], pix[1]
        else:
            r2px = torch.arange(w, device=device).expand(h, w) + col0
            r2py = torch.arange(h, device=device)[:, None].expand(h, w) + row0
        r2_seed = seed_base if seed_base is not None else seed0

        def draw_r2(n, channel):
            return r2_planes(r2_seed, gpass, n, r2px, r2py, channel=channel)

    if state_in is not None:
        st = dict(state_in)
        st["nrays"] = torch.zeros((), dtype=torch.int64, device=device)
    else:
        n_cam = 4 if cfg.aperture > 0.0 else 2  # two lens dimensions under DOF
        if use_r2:
            u = draw_r2(n_cam, R2_CAMERA)
        elif pix is not None:
            u = uniform_pcg_coords(seed0, 0, n_cam, pix[1], pix[0])
        elif window_draw is not None:
            u = window_draw(0, n_cam)
        else:
            u = uniform_pcg(seed0, 0, n_cam, h, w, row0=row0, col0=col0, device=device)
        o, d = _camera_rays(cfg, cam_pos, cam_quat, u[0], u[1], row0=row0, col0=col0,
                            coords=pix, lens=(u[2], u[3]) if n_cam == 4 else None)
        zero = d[0] * 0.0
        o = v3.add(o, v3.scale(d, 0.0))
        st = dict(o=o, d=d, thr=(zero + 1.0, zero + 1.0, zero + 1.0), rad=(zero, zero, zero),
                  alive=torch.ones_like(zero, dtype=torch.bool),
                  prev_did_nee=torch.zeros_like(zero, dtype=torch.bool), prev_pdf=zero,
                  nrays=torch.zeros((), dtype=torch.int64, device=device))
        if scene.has_dispersion:  # no channel committed yet
            st["chan"] = zero - 1.0
        if has_tacc(scene, cfg):  # the ray cone's path length
            st["tacc"] = zero
        if pix is not None:
            st["py"], st["px"] = pix[0].to(torch.int64), pix[1].to(torch.int64)
        elif staged:
            st["px"] = torch.arange(w, device=device).expand(h, w) + col0
            st["py"] = torch.arange(h, device=device)[:, None].expand(h, w) + row0

    draw = window_draw
    if draw is None:
        def draw(ctr, n):
            if "px" in st:
                return uniform_pcg_coords(seed0, ctr, n, st["px"], st["py"])
            return uniform_pcg(seed0, ctr, n, h, w, row0=row0, col0=col0, device=device)
    if use_r2 and cfg.use_nee:
        # bounce 0's NEE light dimensions u[2..4] (draw counter 1) from a 3-D
        # R_d sequence on their own channel; deeper bounces stay random
        random_draw = draw

        def draw(ctr, n):
            u = random_draw(ctr, n)
            if ctr != 1:
                return u
            r2u = draw_r2(3, R2_NEE)
            return tuple(r2u[k - 2] if 2 <= k <= 4 else u[k] for k in range(n))

    for b in range(bounce_lo, bounce_hi + 1):
        st = _bounce(cfg, scene, st, b, draw, counts, bvh)
    if emit_state:
        return st
    return st["rad"], st["nrays"]


def trace_window_planes(*args, **kwargs):
    """Plane-returning core (the staged-launch interface of K5's oracle)."""
    return _trace_core(*args, **kwargs)


def trace_pass_soa(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, key=None,
                   bvh=None, row0=0, band_h=None, packet=None, col0=0, band_w=None,
                   seed0=None, sort=False, probe=None, mesh_light=None, gpass=None,
                   seed_base=None):
    """One sample per pixel: ((h, w, 3) image, nrays). JAX's signature
    (pathtracer/wavefront.py trace_pass_soa), position for position. The
    pass's stream: key, the pass key (see ops/rng.py; required at
    "threefry" and "pallas"), or seed0, the int32 pcg seed in its place (at
    rng="pcg"; else key_to_seed(key)). packet: JAX's choice between the
    packet kernel and the gather traversal for a raw BVH; here a CUDA scene
    always launches K8 and a CPU one traverses plainly, so it is accepted
    and ignored. gpass and seed_base: the global pass index and the
    render's base seed, which key the R_d draws (sampler="r2"). sort and
    probe (ROADMAP.md queue 1 item 7) and mesh_light (item 4, K4 feature
    13) are not ported yet and raise when set."""
    del packet
    if probe is not None:
        _not_yet("probe (the regroup probe)", _COMPACTION)
    if mesh_light is not None:
        _not_yet("mesh_light (mesh lights, feature 13)")
    check_entry(scene, bvh)
    rad, nrays = _trace_core(cfg, scene, cam_pos, cam_quat, seed0, row0, band_h,
                             col0, band_w, bvh=bvh, sort=sort, key=key, gpass=gpass,
                             seed_base=seed_base)
    return v3.stack(rad), nrays


def render_pt_fast(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                   key=None, bvh=None, spp_offset: int = 0, packet=None, sort=False, *,
                   seed=None):
    """Average of spp passes: ((H, W, 3) image, nrays). JAX's signature
    (pathtracer/wavefront.py render_pt_fast), position for position; seed,
    the port's own, is keyword-only.

    key: the render's PRNG key (ops/rng.py key_words: a JAX key's data or
    an int s for jax.random.PRNGKey(s); default PRNGKey(0)). Global pass g
    = spp_offset + i draws, at rng="pcg", from pass_seed(key_to_seed(key),
    g), and otherwise from fold_in(key, g), as in the JAX package. seed:
    the int32 pcg base seed in place of a key (ops.rng_pcg.seed_from_int(s)
    for PRNGKey(s)); pcg only, and not with key.

    bvh: a raw BVH (on a CUDA scene every closest-hit and shadow query
    launches kernel K8, whatever ``packet`` says), a ClusterSet (the gather
    path; kernel K6) or an InstancedClusters (kernel K7), for meshes of any
    size."""
    check_supported(cfg, bvh=bvh, sort=sort)
    check_entry(scene, bvh)
    if cfg.rng == "pcg":
        base = pcg_base_seed(seed, key)
    elif seed is not None:
        raise ValueError(f"rng={cfg.rng!r} draws from a key: pass key=, not the pcg seed=")
    else:
        words = key_words(0 if key is None else key)
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    nrays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for i in range(spp):
        g = int(spp_offset) + i
        if cfg.rng == "pcg":
            img, nr = trace_pass_soa(cfg, scene, cam_pos, cam_quat, bvh=bvh,
                                     seed0=pass_seed(base, g), gpass=g, seed_base=base)
        else:
            img, nr = trace_pass_soa(cfg, scene, cam_pos, cam_quat, bvh=bvh,
                                     key=fold_in(words, g))
        acc = acc + img
        nrays = nrays + nr
    return v3.div(acc, spp), nrays
