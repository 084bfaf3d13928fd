"""Scalar golden renderer (numpy, per-pixel Python loops): a copy of
raytracing_engine_tpu/models/golden.py, the repo's first oracle.

The JAX package's module is numpy only, but importing it pulls in JAX
(through that package's ``__init__``), and this package never imports JAX;
so the port keeps its own copy, the same code on the same float32 inputs.
Its constants and RenderConfig come from this package's config.py, and it
takes this package's Scene (tensors on any device, read to host numpy) as
well as numpy arrays; it renders the same images as the JAX package's,
bit for bit (tests/test_torch_image.py holds it to
tests/golden/golden_64.npz).

The reference repo has NO tests (SURVEY.md §4); this module is the
independent, deliberately-boring implementation of the exact GLSL math that
everything else is validated against:

- cone march "algorithm 3" with lazy per-object SDF caching —
  reference shaders/compute.glsl:34-68, shaders/tracing_algorithms.txt:40-60
- coarse-to-fine depth pyramid seeding — reference compute.glsl:70-87,
  pyramid sizing src/main.rs:203-234, per-level push constants
  src/main.rs:301-307
- Phong shading + sphere-traced soft shadows —
  reference shaders/fragment.glsl:89-187

Everything is float32 to match device semantics. Per-pixel loops are Python:
keep test resolutions small (64–128 px).

Deliberate deviation (documented): GLSL ``pow(x, y)`` is undefined for
x < 0; we clamp the specular base to 0 before ``pow`` (see ``_shade_pixel``),
which agrees with GLSL wherever GLSL is defined.
"""

from __future__ import annotations

import math

import numpy as np

from raytracing_engine_tpu_torch.config import (
    CAM_FALL_OFF,
    LIGHT_FALL_OFF,
    RAY_RADIUS,
    RenderConfig,
)

f32 = np.float32


def _np(x):
    """A tensor on any device (read to the host) or an array -> float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, f32)


def _scene_np(scene):
    """Pull a Scene to host numpy, truncated to live counts."""
    n = int(scene.obj_count)
    nl = int(scene.light_count)
    return dict(
        obj_pos=_np(scene.obj_pos)[:n],
        obj_radius=_np(scene.obj_radius)[:n],
        mat_color=_np(scene.mat_color)[:n],
        mat_shine=_np(scene.mat_shine)[:n],
        mat_ambient=_np(scene.mat_ambient)[:n],
        light_pos=_np(scene.light_pos)[:nl],
        light_color=_np(scene.light_color)[:nl],
    )


def _rotate(q, v):
    """utilities.glsl:26-29 — t = cross(q.xyz,v)+q.w*v; v + 2*cross(q.xyz,t)."""
    qv = q[:3]
    t = np.cross(qv, v) + q[3] * v
    return (v + f32(2.0) * np.cross(qv, t)).astype(f32)


def _sdf_all(p, sc):
    return (np.sqrt(((p - sc["obj_pos"]) ** 2).sum(-1)) - sc["obj_radius"]).astype(f32)


def trace_cone(origin, step, threshold, sc, render_dist):
    """compute.glsl:34-68 — algorithm-3 lazy-cache cone march, scalar ray."""
    distances = _sdf_all(origin, sc)  # cache, one slot per live object
    length = f32(0.0)
    last = f32(0.0)
    render_dist = f32(render_dist)
    threshold = f32(threshold)
    while length < render_dist:
        position = origin + step * length
        radius = (length + f32(1.0)) * threshold
        bound = distances - last
        needs_eval = bound <= radius
        fresh = _sdf_all(position, sc)
        distances = np.where(needs_eval, fresh, bound).astype(f32)
        dist = f32(min(render_dist, distances.min())) if distances.size else render_dist
        last = max(dist, f32(0.0))
        length = f32(length + last)
        if dist <= radius:
            length = f32(length - radius)
            break
    return length


def shadow_ray(origin, step, end, sc):
    """fragment.glsl:89-121 — soft shadow march; gate is the running min."""
    distances = _sdf_all(origin, sc)
    last = f32(0.0)
    nearest = f32(1.0)
    length = f32(0.0)
    while length < end:
        position = origin + step * length
        bound = distances - last
        needs_eval = bound <= nearest
        fresh = _sdf_all(position, sc)
        distances = np.where(needs_eval, fresh, bound).astype(f32)
        dist = f32(min(f32(end), distances.min())) if distances.size else f32(end)
        if dist <= RAY_RADIUS:
            return f32(0.0)
        last = max(dist, f32(0.0))
        nearest = min(nearest, dist)
        length = f32(length + last + f32(RAY_RADIUS))
    return nearest


def render_depth_pyramid(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """compute.glsl main() over every level — returns list of (H, W) arrays."""
    sc = _scene_np(scene)
    pos = _np(cam_pos)
    quat = _np(cam_quat)
    ratio = np.array(cfg.ratio, f32)
    levels = []
    for i, (w, h) in enumerate(cfg.level_dims):
        img_size = np.array(cfg.level_image_size(i), f32)
        threshold = f32(math.sqrt(2.0) * 8.0 * img_size[0])
        depth = np.zeros((h, w), f32)
        prev = levels[i - 1] if i > 0 else None
        for y in range(h):
            for x in range(w):
                nc = ((np.array([x, y], f32) * 2 + 1) * img_size - 1) * ratio
                d = _rotate(quat, np.array([nc[0], 1.0, nc[1]], f32))
                d = (d / f32(np.sqrt((d * d).sum()))).astype(f32)
                seed = f32(1.0) if i == 0 else prev[y // 2, x // 2]
                length = seed + trace_cone(
                    pos + d * seed, d, threshold, sc, cfg.render_dist
                )
                depth[y, x] = max(length, f32(0.0))
        levels.append(depth)
    return levels


def _shade_pixel(cfg, sc, pos, quat, ratio, x, y, total_dist):
    """fragment.glsl main() for one pixel (127-187)."""
    if total_dist >= cfg.render_dist:
        return np.zeros(3, f32)

    view = np.array([cfg.width, cfg.height], f32)
    nc = ((np.array([x, y], f32) + f32(0.5)) * 2 / view - 1) * ratio
    d = _rotate(quat, np.array([nc[0], 1.0, nc[1]], f32))
    d = (d / f32(np.sqrt((d * d).sum()))).astype(f32)

    position = pos + d * total_dist

    dists = _sdf_all(position, sc)
    idx = 0
    for i in range(1, len(dists)):  # strict '<' keeps first on ties (:148-156)
        if dists[i] < dists[idx]:
            idx = i
    obj_pos = sc["obj_pos"][idx]
    mat_color = sc["mat_color"][idx]
    mat_shine = sc["mat_shine"][idx]
    mat_ambient = sc["mat_ambient"][idx]

    cam_dist = f32(np.sqrt(((position - pos) ** 2).sum()))
    cam_fall = max(f32(CAM_FALL_OFF) * (cam_dist * cam_dist + 1), f32(1.0))

    normal = position - obj_pos
    normal = (normal / f32(np.sqrt((normal * normal).sum()))).astype(f32)
    normal_fall = max(f32(np.dot(normal, -d)), f32(0.0))

    color = np.zeros(3, f32)
    for li in range(len(sc["light_pos"])):
        lpos = sc["light_pos"][li]
        lcol = sc["light_color"][li]
        to_light = lpos - position
        light_dist = f32(np.sqrt((to_light * to_light).sum()))
        light_dir = (to_light / light_dist).astype(f32)

        # origin offset 1.0 along the light dir — fragment.glsl:176
        soft = min(shadow_ray(position + light_dir, light_dir, light_dist, sc), f32(1.0))

        light_fall = max(f32(LIGHT_FALL_OFF) * light_dist * light_dist, f32(1.0))
        diffuse = max(f32(np.dot(normal, light_dir)), f32(0.0))
        # reflect(-l, n) = -l - 2*dot(n,-l)*n
        refl = -light_dir - 2 * f32(np.dot(normal, -light_dir)) * normal
        base = max(f32(np.dot(refl, -d)), f32(0.0))  # clamp: GLSL pow undef x<0
        spec = max(diffuse * f32(base**mat_shine), f32(0.0))

        direct = max(diffuse + spec, f32(0.0)) * lcol / light_fall * soft
        color += (mat_ambient + direct) / cam_fall * normal_fall * mat_color
    return color.astype(f32)


def shade(cfg: RenderConfig, scene, depth_finest, cam_pos, cam_quat):
    """Shade the full image from the finest depth level (cropped to cfg res)."""
    sc = _scene_np(scene)
    pos = _np(cam_pos)
    quat = _np(cam_quat)
    depth_finest = _np(depth_finest)
    ratio = np.array(cfg.ratio, f32)
    img = np.zeros((cfg.height, cfg.width, 3), f32)
    for y in range(cfg.height):
        for x in range(cfg.width):
            img[y, x] = _shade_pixel(cfg, sc, pos, quat, ratio, x, y, depth_finest[y, x])
    return img


def render(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """Full golden frame: depth pyramid + shading → (H, W, 3) float32."""
    levels = render_depth_pyramid(cfg, scene, cam_pos, cam_quat)
    return shade(cfg, scene, levels[-1], cam_pos, cam_quat)
