"""K1: one depth-pyramid level through the CUDA kernel ``depth_kernel``
(csrc/conemarch.cu), which replaces raytracing_engine_tpu/ops/pallas/depth.py
``_depth_kernel``. The kernel reads its seed from the previous level's pixel
[y/2, x/2], so the 2x upsample between levels costs no pass of its own.

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


def depth_level_reference(cfg, level: int, scene, cam_pos, cam_quat, prev=None):
    """Plain PyTorch version: ray-gen, seed upsample and the whole-image cone
    march of models/conemarch.py → (h, w)."""
    return conemarch.render_depth_level(cfg, level, scene, cam_pos, cam_quat, prev)


def depth_level(cfg, level: int, scene, cam_pos, cam_quat, prev=None):
    """One pyramid level → (h, w) float32. prev: the previous level (h', w'),
    or None at level 0 (seed 1, the near plane)."""
    global launches
    if scene.device.type == "cpu":
        return depth_level_reference(cfg, level, scene, cam_pos, cam_quat, prev)
    w, h = cfg.level_dims[level]
    args = common.scene_args(cfg, scene, cam_pos, cam_quat, level)
    common.set_seed_source(args, prev, h, w, scene.device)
    out = torch.empty((h, w), dtype=torch.float32, device=scene.device)
    args.out, args.w, args.h = out.data_ptr(), w, h
    common.launch("conemarch_depth", args)
    launches += 1
    return out
