"""Quaternion math, [x, y, z, w] layout (glam / GLSL vec4 convention).

``rotate(q, v) = v + 2*cross(q.xyz, cross(q.xyz, v) + q.w*v)`` (reference
shaders/utilities.glsl:26-29); the camera quaternion is
``from_rotation_z(-yaw) * from_rotation_x(pitch)`` (reference
src/main.rs:402-404). Batched over leading axes.

Every sum is written out in the order the CUDA kernels use (csrc/conemarch.cuh),
so the plain versions and the kernels round alike.
"""

from __future__ import annotations

import torch


def quat_identity(device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=device)


def quat_from_rotation_x(angle):
    """glam Quat::from_rotation_x: rotation of `angle` radians about +X."""
    half = 0.5 * angle
    s, c = torch.sin(half), torch.cos(half)
    z = torch.zeros_like(s)
    return torch.stack([s, z, z, c], dim=-1)


def quat_from_rotation_z(angle):
    """glam Quat::from_rotation_z: rotation of `angle` radians about +Z."""
    half = 0.5 * angle
    s, c = torch.sin(half), torch.cos(half)
    z = torch.zeros_like(s)
    return torch.stack([z, z, s, c], dim=-1)


def quat_mul(a, b):
    """Hamilton product a*b ([x,y,z,w] layout): apply b first, then a."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def cross(a, b):
    """3-vector cross product over the last axis."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion q (..., 4):
        t = cross(q.xyz, v) + q.w * v
        return v + 2 * cross(q.xyz, t)
    """
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = cross(qv, v) + qw * v
    return v + 2.0 * cross(qv, t)
