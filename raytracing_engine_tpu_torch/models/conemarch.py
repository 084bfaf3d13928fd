"""Plain PyTorch cone-march renderer — the reference-parity pipeline.

One frame = N depth-pyramid passes (coarse → fine, each seeded from the
previous level — reference compute.glsl:70-87, pyramid sizing
src/main.rs:203-234) followed by the shading pass (fragment.glsl:127-187).
It is the oracle the CUDA kernels (ops/cuda/) are held to, and the renderer
for scenes on the CPU.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.ops.march import cone_march
from raytracing_engine_tpu_torch.ops.raygen import pixel_norm_coords, ray_directions
from raytracing_engine_tpu_torch.ops.shade import phong_shade


def level_directions(cfg: RenderConfig, level: int, cam_quat):
    """(h, w, 3) unit ray directions of one pyramid level."""
    w, h = cfg.level_dims[level]
    nc = pixel_norm_coords(w, h, cfg.level_image_size(level), cfg.ratio,
                           device=cam_quat.device)
    return ray_directions(nc, cam_quat)


def check_seed_source(prev_shape, h: int, w: int):
    """Raise unless an (h, w) level can read its seed at [y//2, x//2] of a
    previous level of shape prev_shape."""
    if len(prev_shape) != 2 or (h - 1) // 2 >= prev_shape[0] or (w - 1) // 2 >= prev_shape[1]:
        raise ValueError(f"level ({h}, {w}) cannot be seeded from {tuple(prev_shape)}")


def upsample_seed(prev_depth, h: int, w: int):
    """Nearest 2x upsample: seed[y, x] = prev[y//2, x//2] — compute.glsl:81."""
    check_seed_source(prev_depth.shape, h, w)
    rows = torch.arange(h, device=prev_depth.device) // 2
    cols = torch.arange(w, device=prev_depth.device) // 2
    return prev_depth[rows][:, cols]


def render_depth_level(cfg: RenderConfig, level: int, scene, cam_pos, cam_quat,
                       prev_depth=None):
    """One depth-pyramid level (compute.glsl main(), :70-87) → (h, w).
    prev_depth: the previous level, or None at level 0 (seed = near plane)."""
    w, h = cfg.level_dims[level]
    direction = level_directions(cfg, level, cam_quat)
    if prev_depth is None:
        seed = torch.ones((h, w), dtype=torch.float32, device=direction.device)
    else:
        seed = upsample_seed(prev_depth, h, w)
    obj_mask = torch.arange(scene.obj_pos.shape[0], device=direction.device) < scene.obj_count
    origin = cam_pos + direction * seed[..., None]
    marched = cone_march(origin, direction, cfg.level_threshold(level),
                         scene.obj_pos, scene.obj_radius, obj_mask,
                         cfg.render_dist, cfg.max_march_steps)
    return torch.clamp_min(seed + marched, 0.0)  # compute.glsl:86


def render_depth_pyramid(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """All levels, coarse → fine: a tuple of (h, w) tensors."""
    levels = []
    prev = None
    for i in range(cfg.level_count):
        prev = render_depth_level(cfg, i, scene, cam_pos, cam_quat, prev)
        levels.append(prev)
    return tuple(levels)


def shade(cfg: RenderConfig, scene, cam_pos, cam_quat, depth):
    """Phong shading of the finest depth level (H, W) → (H, W, 3)."""
    direction = level_directions(cfg, cfg.level_count - 1, cam_quat)
    return phong_shade(depth, direction, cam_pos, scene, cfg.render_dist,
                       cfg.max_shadow_steps)


def render(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """Full frame: depth pyramid + shading → (H, W, 3) float32. The finest
    level is the output resolution (RenderConfig enforces multiples of 8)."""
    depth = render_depth_pyramid(cfg, scene, cam_pos, cam_quat)[-1]
    return shade(cfg, scene, cam_pos, cam_quat, depth)


def render_jit(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """JAX's jitted entry (models/conemarch.render_jit), same arguments: the
    eager render, since PyTorch has nothing to compile here."""
    return render(cfg, scene, cam_pos, cam_quat)
