"""K2: the finest level's march and its shading in one CUDA kernel,
``fused_kernel`` (csrc/conemarch.cu), which replaces
raytracing_engine_tpu/ops/pallas/fused.py ``_fused_kernel``. The depth stays
in a register; the kernel shares its device functions with K1 and K3, so its
image equals depth_level + shade bit for bit.

A scene on the CPU takes the plain version; a scene on a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.ops.cuda import common
from raytracing_engine_tpu_torch.ops.cuda.depth import depth_level_reference
from raytracing_engine_tpu_torch.ops.cuda.shade import shade_reference

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0


def fused_reference(cfg, scene, cam_pos, cam_quat, prev=None):
    """Plain PyTorch version: the plain finest level, then the plain shading."""
    depth = depth_level_reference(cfg, cfg.level_count - 1, scene, cam_pos,
                                  cam_quat, prev)
    return shade_reference(cfg, scene, cam_pos, cam_quat, depth)


def depth_shade_fused(cfg, scene, cam_pos, cam_quat, prev=None):
    """March the finest level from the previous level `prev` (None: seed 1)
    and shade → (H, W, 3) float32."""
    global launches
    if scene.device.type == "cpu":
        return fused_reference(cfg, scene, cam_pos, cam_quat, prev)
    level = cfg.level_count - 1
    w, h = cfg.level_dims[level]
    args = common.scene_args(cfg, scene, cam_pos, cam_quat, level)
    common.set_seed_source(args, prev, h, w, scene.device)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=scene.device)
    args.out, args.w, args.h = out.data_ptr(), w, h
    common.launch("conemarch_fused", args)
    launches += 1
    return out
