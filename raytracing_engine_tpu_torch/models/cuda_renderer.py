"""Cone-march renderer through the CUDA kernels.

The launch sequence of raytracing_engine_tpu/models/pallas_renderer.py, with
the pyramid in one launch: with ``fused=True`` one K1 launch of levels
0..level_count - 2, then one fused march + shade launch (K2); with
``fused=False`` one K1 launch of every level, then the shade kernel (K3).
Each launch reads the previous level directly, so no upsample pass runs.
Scenes on the CPU go through the kernels' plain versions.
"""

from __future__ import annotations

from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.ops.cuda.depth import depth_pyramid
from raytracing_engine_tpu_torch.ops.cuda.fused import depth_shade_fused
from raytracing_engine_tpu_torch.ops.cuda.shade import shade


def render_depth_pyramid(cfg: RenderConfig, scene, cam_pos, cam_quat):
    """All levels, coarse → fine: a tuple of (h, w) tensors (one K1 launch)."""
    return depth_pyramid(cfg, scene, cam_pos, cam_quat)


def render(cfg: RenderConfig, scene, cam_pos, cam_quat, fused=True):
    """Full frame → (H, W, 3) float32. fused=True marches the finest level
    and shades in one kernel, bit for bit the two-kernel image."""
    if not fused:
        depth = render_depth_pyramid(cfg, scene, cam_pos, cam_quat)[-1]
        return shade(cfg, scene, cam_pos, cam_quat, depth)
    last = cfg.level_count - 2
    prev = depth_pyramid(cfg, scene, cam_pos, cam_quat, last)[-1] if last >= 0 else None
    return depth_shade_fused(cfg, scene, cam_pos, cam_quat, prev)
