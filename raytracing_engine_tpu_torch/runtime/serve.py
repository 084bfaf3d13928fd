"""Render a sequence of camera poses into one (K, 3, H, W) tensor.

- independent=True (default): frames are independent (a batch of requests,
  an orbit).
- independent=False: each frame's camera position gets a zero-valued carry
  from the previous frame's corner pixel (adds exactly 0.0 unless a frame
  has non-finite pixels), as the JAX package's render_sequence does, so each
  frame depends on the one before it.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.models import cuda_renderer


def render_sequence(cfg: RenderConfig, scene, positions, quats, fn=None,
                    independent=True):
    """(K, 3) positions + (K, 4) quats → (K, 3, H, W) channel-major frames on
    the scene's device. fn: render function (cfg, scene, pos, quat) →
    (H, W, 3); defaults to the CUDA-kernel renderer (its plain versions for a
    scene on the CPU)."""
    render = fn if fn is not None else cuda_renderer.render
    device = scene.device
    positions = torch.as_tensor(positions, dtype=torch.float32).to(device)
    quats = torch.as_tensor(quats, dtype=torch.float32).to(device)
    frames = torch.empty((positions.shape[0], 3, cfg.height, cfg.width),
                         dtype=torch.float32, device=device)
    carry = None
    for k in range(positions.shape[0]):
        pos = positions[k, :3] if carry is None else positions[k, :3] + carry
        img = render(cfg, scene, pos, quats[k])
        frames[k] = img.permute(2, 0, 1)
        if not independent:
            carry = img[0, 0, 0] * 0.0
    return frames
