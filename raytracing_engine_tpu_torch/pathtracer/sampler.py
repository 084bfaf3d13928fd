"""Monte-Carlo sampling on component planes
(raytracing_engine_tpu/pathtracer/sampler.py:17-76).

Every sampler takes uniform [0, 1) planes and returns V3 planes
(ops/vec3.py), in the JAX operation order. The GGX functions come with the
metal slice (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import math

import torch

from raytracing_engine_tpu_torch.ops import vec3 as v3

PI = math.pi


def build_onb(n):
    """Branchless orthonormal basis around unit normal n (Duff et al. 2017)."""
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    s = (b, sign + ny * ny * a, -ny)
    return t, s


def cosine_hemisphere(u1, u2, normal):
    """Cosine-weighted direction about `normal`; pdf = cos/π.
    Returns (dir V3, pdf plane)."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t, s = build_onb(normal)
    d = v3.add(v3.add(v3.scale(t, x), v3.scale(s, y)), v3.scale(normal, z))
    return d, v3.div(z, PI)


def reflect(d, n):
    """Mirror reflection of incoming direction d about normal n."""
    return v3.sub(d, v3.scale(n, 2.0 * v3.dot(d, n)))


def sample_sphere_area(u1, u2, center, radius):
    """Uniform point on the full sphere surface: (point V3, normal V3);
    pdf_area = 1/(4πr²) is the caller's."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    n = (r * torch.cos(phi), r * torch.sin(phi), z)
    p = v3.add(center, v3.scale(n, radius))
    return p, n


def sample_triangle_area(u1, u2, p0, e1, e2):
    """Uniform point on a triangle (sqrt warp); normal = normalize(e1×e2);
    pdf_area = 1/area is the caller's."""
    su = torch.sqrt(u1)
    b1 = su * (1.0 - u2)
    b2 = su * u2
    p = v3.add(p0, v3.add(v3.scale(e1, b1), v3.scale(e2, b2)))
    n, _ = v3.normalize(v3.cross(e1, e2))
    return p, n


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (β=2): w_a = pdf_a² / (pdf_a² + pdf_b²)."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-24)
