"""Signed distance functions over the sphere scene.

``sphereSDF(p, s) = distance(p, s.pos) - s.size`` (reference
shaders/utilities.glsl:36-38), evaluated for all objects along a trailing
object axis.
"""

from __future__ import annotations

import torch


def dot3(a, b):
    """Dot product over the last axis, summed as (x + y) + z — the order of
    the CUDA kernels."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sphere_sdf(p, center, radius):
    """SDF of one sphere. p: (..., 3); center: (3,); radius: scalar."""
    d = p - center
    return torch.sqrt(dot3(d, d)) - radius


def scene_sdf_all(p, obj_pos, obj_radius):
    """SDF of every object at p: p (..., 3), obj_pos (K, 3), obj_radius (K,)
    → (..., K) distances (unmasked — callers mask by obj_count)."""
    d = p[..., None, :] - obj_pos
    return torch.sqrt(dot3(d, d)) - obj_radius
