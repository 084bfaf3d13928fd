"""Camera ray generation.

Z-up, Y-forward, X-right (reference src/main.rs:350-357). A pixel's
normalized coordinate nc maps to the camera-space direction (nc.x, 1, nc.y),
rotated by the camera quaternion and normalized (reference
compute.glsl:70-77). Per level: normCoord = ((id*2 + 1) * imageSize - 1) * ratio.
Image row 0 is +z (gl_FragCoord's y runs downward), as in the JAX package.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.ops.quaternion import quat_rotate
from raytracing_engine_tpu_torch.ops.sdf import dot3


def pixel_norm_coords(level_w: int, level_h: int, image_size, ratio, device=None):
    """Normalized coords of one pyramid level's pixels → (level_h, level_w, 2);
    [..., 0] is x, [..., 1] is y. image_size and ratio are (x, y) pairs of
    floats (RenderConfig.level_image_size, RenderConfig.ratio)."""
    ix = torch.arange(level_w, dtype=torch.float32, device=device)
    iy = torch.arange(level_h, dtype=torch.float32, device=device)
    ncx = ((ix * 2.0 + 1.0) * image_size[0] - 1.0) * ratio[0]
    ncy = ((iy * 2.0 + 1.0) * image_size[1] - 1.0) * ratio[1]
    gx = ncx[None, :].expand(level_h, level_w)
    gy = ncy[:, None].expand(level_h, level_w)
    return torch.stack([gx, gy], dim=-1)


def ray_directions(norm_coords, rot_quat):
    """Unit ray directions: normalize(rotate(q, (nc.x, 1, nc.y)))
    (reference compute.glsl:77). norm_coords: (..., 2); rot_quat: (4,)."""
    ncx = norm_coords[..., 0]
    v = torch.stack([ncx, torch.ones_like(ncx), norm_coords[..., 1]], dim=-1)
    v = quat_rotate(rot_quat, v)
    return v / torch.sqrt(dot3(v, v))[..., None]
