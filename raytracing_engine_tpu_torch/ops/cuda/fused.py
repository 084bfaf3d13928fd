"""K2: the finest level's march and its shading in one CUDA kernel,
``fused_kernel`` (csrc/conemarch.cu), which replaces
raytracing_engine_tpu/ops/pallas/fused.py ``_fused_kernel``. The depth stays
in a register; the kernel shares its device functions with K1 and K3, so its
image equals the finest K1 level + shade bit for bit.

A scene on the CPU takes the plain version; a scene on a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.ops.cuda import common
from raytracing_engine_tpu_torch.ops.cuda.depth import check_prev_level, depth_level_reference
from raytracing_engine_tpu_torch.ops.cuda.shade import shade_reference

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0


def fused_reference(cfg, scene, cam_pos, cam_quat, prev=None):
    """Plain PyTorch version: the plain finest level, then the plain shading."""
    depth = depth_level_reference(cfg, cfg.level_count - 1, scene, cam_pos,
                                  cam_quat, prev)
    return shade_reference(cfg, scene, cam_pos, cam_quat, depth)


def depth_shade_fused(cfg, scene, cam_pos, cam_quat, prev=None, interpret=None, n_obj=None,
                      n_light=None):
    """March the finest level from the previous level `prev` (None: seed 1)
    and shade → (H, W, 3) float32.

    prev must be exactly the level before the finest, cfg.level_dims[-2] as
    (h, w). JAX's depth_shade_fused takes the full-resolution seed,
    upsample_seed(prev, H, W), in this place: it is refused with a
    ValueError, on every device (ops/cuda/depth.check_prev_level).
    interpret, n_obj and n_light are JAX's TPU knobs, accepted and ignored:
    the kernel reads the scene's live counts, and the image is the same."""
    global launches
    del interpret, n_obj, n_light
    level = cfg.level_count - 1
    check_prev_level(cfg, level, prev)
    if scene.device.type == "cpu":
        return fused_reference(cfg, scene, cam_pos, cam_quat, prev)
    w, h = cfg.level_dims[level]
    args = common.scene_args(cfg, scene, cam_pos, cam_quat, level)
    common.set_seed_source(args, prev, h, w, scene.device)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=scene.device)
    args.out, args.w, args.h = out.data_ptr(), w, h
    common.launch("conemarch_fused", args)
    launches += 1
    return out
