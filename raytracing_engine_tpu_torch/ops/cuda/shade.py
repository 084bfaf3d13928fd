"""K3: Phong shading with soft shadows from a finished depth image, through
the CUDA kernel ``shade_kernel`` (csrc/conemarch.cu), which replaces
raytracing_engine_tpu/ops/pallas/shade.py ``_shade_kernel``. It is the
two-kernel path (``cuda_renderer.render(fused=False)``); the fused kernel runs
the same device function.

A scene on the CPU takes the plain version; a scene on a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.models import conemarch
from raytracing_engine_tpu_torch.ops.cuda import common

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0


def shade_reference(cfg, scene, cam_pos, cam_quat, depth):
    """Plain PyTorch version: finest-level ray-gen and ops/shade.phong_shade
    → (H, W, 3)."""
    return conemarch.shade(cfg, scene, cam_pos, cam_quat, depth)


def shade(cfg, scene, cam_pos, cam_quat, depth):
    """Shade the finest depth level (H, W) → (H, W, 3) float32."""
    global launches
    if scene.device.type == "cpu":
        return shade_reference(cfg, scene, cam_pos, cam_quat, depth)
    level = cfg.level_count - 1
    w, h = cfg.level_dims[level]
    args = common.scene_args(cfg, scene, cam_pos, cam_quat, level)
    common.check(depth, "depth", (h, w), torch.float32, scene.device)
    args.src, args.src_w, args.src_h = depth.data_ptr(), w, h
    out = torch.empty((h, w, 3), dtype=torch.float32, device=scene.device)
    args.out, args.w, args.h = out.data_ptr(), w, h
    common.launch("conemarch_shade", args)
    launches += 1
    return out
