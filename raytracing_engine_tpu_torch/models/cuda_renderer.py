"""Cone-march renderer through the CUDA kernels.

The launch sequence of raytracing_engine_tpu/models/pallas_renderer.py: with
``fused=True`` (level_count - 1) depth launches (K1), then one fused
march + shade launch (K2); with ``fused=False`` every level through K1, then
the shade kernel (K3). Each level reads the previous one directly, so no
upsample pass runs between launches. Scenes on the CPU go through the
kernels' plain versions.
"""

from __future__ import annotations

from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.ops.cuda.depth import depth_level
from raytracing_engine_tpu_torch.ops.cuda.fused import depth_shade_fused
from raytracing_engine_tpu_torch.ops.cuda.shade import shade


def render_depth_pyramid(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """All levels, coarse → fine: a tuple of (h, w) tensors."""
    levels = []
    prev = None
    for i in range(cfg.level_count):
        prev = depth_level(cfg, i, scene, cam_pos, cam_quat, prev)
        levels.append(prev)
    return tuple(levels)


def render(cfg: RenderConfig, scene, cam_pos, cam_quat, fused=True):
    """Full frame → (H, W, 3) float32. fused=True marches the finest level
    and shades in one kernel, bit for bit the two-kernel image."""
    if not fused:
        depth = render_depth_pyramid(cfg, scene, cam_pos, cam_quat)[-1]
        return shade(cfg, scene, cam_pos, cam_quat, depth)
    prev = None
    for i in range(cfg.level_count - 1):
        prev = depth_level(cfg, i, scene, cam_pos, cam_quat, prev)
    return depth_shade_fused(cfg, scene, cam_pos, cam_quat, prev)
