"""Tuple-of-planes vec3 helpers (raytracing_engine_tpu/ops/vec3.py).

A V3 is any 3-tuple of same-shape tensors. The path tracer's plain version
keeps the JAX package's (H, W) component planes so that every expression
reads, and rounds, as the JAX code does; the CUDA kernel holds the same
values in registers.
"""

from __future__ import annotations

import torch


def v3(x, y, z):
    return (x, y, z)


def splat(vec, like=None):
    """Lift a (3,) tensor / tuple of scalars to a V3 (broadcast as needed)."""
    x, y, z = vec[0], vec[1], vec[2]
    if like is not None:
        x, y, z = (torch.as_tensor(c, dtype=like.dtype, device=like.device)
                   .expand(like.shape) for c in (x, y, z))
    return (x, y, z)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Elementwise (Hadamard) product of two V3s."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    n = length(a)
    return (a[0] / n, a[1] / n, a[2] / n), n


def where(cond, a, b):
    return (
        torch.where(cond, a[0], b[0]),
        torch.where(cond, a[1], b[1]),
        torch.where(cond, a[2], b[2]),
    )


def neg(a):
    return (-a[0], -a[1], -a[2])


def stack(a, dim=-1):
    """V3 -> (..., 3) tensor (host/output boundary only)."""
    return torch.stack(list(a), dim=dim)


def unstack(t, dim=-1):
    """(..., 3) tensor -> V3."""
    return tuple(t.unbind(dim))


def div(a, c: float):
    """a / c by IEEE division for a Python number c. PyTorch's CUDA path
    turns division by a host scalar into a multiplication by its reciprocal,
    which rounds differently; a 0-dim tensor on a's device keeps the true
    quotient, as the CUDA kernels and the JAX package compute it."""
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)
