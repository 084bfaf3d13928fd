"""Shaded rendering of instanced scenes (raytracing_engine_tpu/models/
instanced.py; BASELINE config 5).

The instanced cluster intersector (kernel K7 on a CUDA device, its plain
version on the CPU) returns (t, code, world normal) of the camera rays; the
instance's material comes from code // padded_tris; the lighting is the
reference's Blinn/Phong planes math (fragment.glsl:162-185 falloffs) in
plain PyTorch ops, as the JAX package leaves it to XLA; shadows are one
more any-hit K7 launch toward the light per shadow sample. K7 is the only
kernel of this path.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
from raytracing_engine_tpu_torch.ops.rng_pcg import uniform_pcg
from raytracing_engine_tpu_torch.pathtracer.wavefront import _sel


def camera_rays(cam_pos, yaw, width: int, height: int, fov: float = 1.0, row0: int = 0,
                band_h=None):
    """(o, d) planes of rows row0 .. row0 + band_h - 1 of the camera at
    cam_pos (3,) with yaw about +Z, looking +Y (src/main.rs:402-414), keyed
    on full-image coordinates."""
    f32 = torch.float32
    dev = cam_pos.device
    yaw = torch.as_tensor(yaw, dtype=f32, device=dev)
    bh = band_h or height
    iy = torch.arange(bh, dtype=torch.int32, device=dev)[:, None].expand(bh, width) + row0
    ix = torch.arange(width, dtype=torch.int32, device=dev)[None, :].expand(bh, width)
    ncx = ((ix.to(f32) + 0.5) * 2.0 / width - 1.0) * fov
    ncy = ((iy.to(f32) + 0.5) * 2.0 / height - 1.0) * (fov * height / width)

    cy, sy = torch.cos(yaw), torch.sin(yaw)
    dx = ncx * cy - sy
    dy = ncx * sy + cy
    dz = ncy
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    d = (dx * inv, dy * inv, dz * inv)
    o = tuple(cam_pos[i].expand(d[0].shape) + 0.0 * d[0] for i in range(3))
    return o, d


def _surface(o, d, hits, light_pos, eps):
    """The lighting terms of the closest hits (t, code, nx, ny, nz) of rays
    (o, d): hit, the unit normal facing the ray, the hit point, the unit
    direction to the light point and its distance, n.l, and the shadow-ray
    origins: nudged by eps along the normal where occlusion can change the
    lighting, parked elsewhere (misses and back-facing hits: the sentinel
    origin fails every slab test and counts as blocked at once in the
    any-hit sweep)."""
    t, code, nx, ny, nz = hits
    hit = code >= 0

    nl = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    nx, ny, nz = nx / nl, ny / nl, nz / nl
    flip = torch.where(nx * d[0] + ny * d[1] + nz * d[2] > 0.0, -1.0, 1.0)
    n = (nx * flip, ny * flip, nz * flip)

    th = torch.where(hit, t, 0.0)
    p = tuple(o[a] + d[a] * th for a in range(3))

    lx = light_pos[0] - p[0]
    ly = light_pos[1] - p[1]
    lz = light_pos[2] - p[2]
    ldist = torch.sqrt(lx * lx + ly * ly + lz * lz)
    linv = 1.0 / torch.clamp_min(ldist, 1e-20)
    ldir = (lx * linv, ly * linv, lz * linv)
    ndotl = torch.clamp_min(n[0] * ldir[0] + n[1] * ldir[1] + n[2] * ldir[2], 0.0)

    cand = hit & (ndotl > 0.0)
    dead = 1e18
    so = tuple(torch.where(cand, p[a] + n[a] * eps, dead) for a in range(3))
    return hit, n, p, ldir, ldist, ndotl, so


def shadow_rays(o, d, hits, light_pos, eps=1e-2):
    """The hard-shadow rays render_instanced_phong casts from the closest
    hits (t, code, nx, ny, nz) of rays (o, d) toward the point light at
    light_pos: (origins, unit directions, t_max) of its any-hit query, the
    origins of misses and back-facing hits parked at 1e18."""
    _, _, _, ldir, ldist, _, so = _surface(o, d, hits, light_pos, eps)
    return so, ldir, ldist * (1.0 - 1e-3)


def _render(intersect, inst_tab, cs, inst_mat, mat_albedo, cam_pos, yaw, light_pos, width,
            height, fov, light_color, ambient, shininess, eps, shadows, light_radius,
            shadow_samples, seed, sample_offset, row0, band_h):
    """render_instanced_phong with `intersect` as the instanced intersector
    (K7's wrapper or its plain version)."""
    dev = inst_tab.device
    f32 = torch.float32
    cam_pos = torch.as_tensor(cam_pos, dtype=f32, device=dev)
    light_pos = torch.as_tensor(light_pos, dtype=f32, device=dev)
    bh = band_h or height
    o, d = camera_rays(cam_pos, yaw, width, height, fov, row0, band_h)
    # the frame's visit orders from the camera, shared by every launch
    orders = dict(zip(("iorder", "iorders"), kinst.instance_orders(inst_tab, cs, cam_pos)))

    hits = intersect(inst_tab, cs, o, d, attrs=True, **orders)
    t, code = hits[0], hits[1]
    hit, (nx, ny, nz), (px, py, pz), (lx, ly, lz), ldist, ndotl, so = _surface(
        o, d, hits, light_pos, eps)

    n_inst = inst_tab.shape[0]
    inst_id = torch.where(hit, code // cs.padded_tris, 0).to(torch.int64)
    mat_id = _sel(inst_id, torch.as_tensor(inst_mat, device=dev), n_inst).to(torch.int64)
    M = mat_albedo.shape[0]
    alb = tuple(_sel(mat_id, mat_albedo[:, c], M) for c in range(3))

    # Blinn half-vector spec (view dir = -d)
    hx, hy, hz = lx - d[0], ly - d[1], lz - d[2]
    hn = torch.clamp_min(torch.sqrt(hx * hx + hy * hy + hz * hz), 1e-20)
    spec = torch.clamp_min((nx * hx + ny * hy + nz * hz) / hn, 0.0) ** shininess
    spec = torch.where(ndotl > 0.0, spec, 0.0)

    if shadows:
        def occluded(sdir, sdist):
            _, scode = intersect(inst_tab, cs, so, sdir, any_hit=True,
                                 t_max=sdist * (1.0 - 1e-3), **orders)
            return torch.where(scode >= 0, 0.0, 1.0)

        # any positive light_radius samples the area light, even at N = 1
        if light_radius > 0.0:
            vis = torch.zeros_like(ldist)
            for s in range(shadow_samples):
                u1, u2 = uniform_pcg(seed, sample_offset + s, 2, bh, width, row0=row0,
                                     device=dev)
                z = 1.0 - 2.0 * u1
                rr = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
                phi = 2.0 * np.pi * u2
                sx = light_pos[0] + light_radius * rr * torch.cos(phi) - px
                sy_ = light_pos[1] + light_radius * rr * torch.sin(phi) - py
                sz = light_pos[2] + light_radius * z - pz
                sdist = torch.sqrt(sx * sx + sy_ * sy_ + sz * sz)
                sinv = 1.0 / torch.clamp_min(sdist, 1e-20)
                vis = vis + occluded((sx * sinv, sy_ * sinv, sz * sinv), sdist)
            lit = vis / shadow_samples
        else:
            lit = occluded((lx, ly, lz), ldist)
    else:
        lit = 1.0

    # fragment.glsl:162-185 falloffs
    light_fall = torch.clamp_min(0.01 * ldist * ldist, 1.0)
    cam_fall = torch.clamp_min(0.01 * (t * t + 1.0), 1.0)
    cam_fall = torch.where(hit, cam_fall, 1.0)
    norm_fall = torch.clamp_min(-(nx * d[0] + ny * d[1] + nz * d[2]), 0.0)

    out = []
    for ch, lc in zip(alb, light_color):
        c = (ambient + (ndotl + spec) * lc / light_fall * lit) / cam_fall * norm_fall * ch
        out.append(torch.where(hit, c, 0.0))
    return torch.stack(out, dim=-1)


def render_instanced_phong(inst_tab, cs, inst_mat, mat_albedo, cam_pos, yaw, light_pos,
                           width=1920, height=1088, fov=1.0,
                           light_color=(300.0, 300.0, 290.0), ambient=0.08, shininess=32.0,
                           eps=1e-2, shadows=True, interpret=None, light_radius=0.0,
                           shadow_samples=1, seed=0, sample_offset=0, row0=0, band_h=None):
    """Phong-shaded frame of an instanced scene: (band_h or H, W, 3) f32.

    inst_tab: ops.cuda.instanced.pack_instances(...) (N, 24); cs: the base
    mesh's ClusterSet; inst_mat: (N,) int32 per-instance material id;
    mat_albedo: (M, 3). Camera: position + yaw about +Z looking +Y
    (src/main.rs:402-414 convention). Shadows: one any-hit K7 launch per
    shadow sample; light_radius > 0 averages `shadow_samples` pcg-jittered
    points on the light sphere (deterministic per pixel for a seed;
    sample_offset shifts the draw counter). row0/band_h: only rows row0 ..
    row0 + band_h - 1; the camera and the samples stay keyed on full-image
    coordinates, so a band equals the same rows of the full render bit for
    bit. interpret is a TPU knob, accepted and ignored. On a CUDA device the
    intersections launch K7; on the CPU they take its plain version."""
    del interpret
    return _render(kinst.instanced_cluster_intersect, inst_tab, cs, inst_mat, mat_albedo,
                   cam_pos, yaw, light_pos, width, height, fov, light_color, ambient,
                   shininess, eps, shadows, light_radius, shadow_samples, seed, sample_offset,
                   row0, band_h)


def render_instanced_phong_reference(inst_tab, cs, inst_mat, mat_albedo, cam_pos, yaw,
                                     light_pos, width=1920, height=1088, fov=1.0,
                                     light_color=(300.0, 300.0, 290.0), ambient=0.08,
                                     shininess=32.0, eps=1e-2, shadows=True, interpret=None,
                                     light_radius=0.0, shadow_samples=1, seed=0,
                                     sample_offset=0, row0=0, band_h=None):
    """render_instanced_phong through K7's plain version on any device: the
    kernel's oracle on the card."""
    del interpret
    return _render(kinst.instanced_cluster_intersect_reference, inst_tab, cs, inst_mat,
                   mat_albedo, cam_pos, yaw, light_pos, width, height, fov, light_color,
                   ambient, shininess, eps, shadows, light_radius, shadow_samples, seed,
                   sample_offset, row0, band_h)
