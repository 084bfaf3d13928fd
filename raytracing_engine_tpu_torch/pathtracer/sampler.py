"""Monte-Carlo sampling on component planes
(raytracing_engine_tpu/pathtracer/sampler.py).

Every sampler takes uniform [0, 1) planes and returns V3 planes
(ops/vec3.py), in the JAX operation order, including the GGX microfacet
functions of the METAL material (isotropic and anisotropic). Schlick's
``x ** 5`` is written as the products XLA lowers an integer power to,
``x * ((x * x) * (x * x))``, here and in csrc/pt.cuh: no ``pow``.
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


# --- GGX microfacet (rough conductor) ----------------------------------------

def schlick5(x):
    """x ** 5 as XLA's integer power computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def ggx_d(cos_h, alpha):
    """GGX / Trowbridge-Reitz NDF D(h) for the half-vector cosine cos_h
    against the shading normal; alpha = roughness² (Disney remap)."""
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(PI * denom * denom, 1e-12)


def ggx_smith_g1(cos_v, alpha):
    """Separable Smith masking G1 for one direction (cosine against the
    shading normal)."""
    a2 = alpha * alpha
    c = torch.clamp_min(cos_v, 1e-6)
    return 2.0 * c / torch.clamp_min(c + torch.sqrt(a2 + (1.0 - a2) * c * c), 1e-12)


def sample_ggx_h(u1, u2, normal, alpha):
    """A half-vector from the GGX NDF about `normal` (pdf_h = D(h)·cos_h):
    (h V3, cos_h plane)."""
    a2 = alpha * alpha
    cos_h = torch.sqrt(torch.clamp((1.0 - u1) / (1.0 + (a2 - 1.0) * u1), 0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp_min(1.0 - cos_h * cos_h, 0.0))
    phi = 2.0 * PI * u2
    t, s = build_onb(normal)
    h = v3.add(v3.add(v3.scale(t, sin_h * torch.cos(phi)), v3.scale(s, sin_h * torch.sin(phi))),
               v3.scale(normal, cos_h))
    return h, cos_h


def ggx_d_aniso(hx, hy, hz, ax, ay):
    """Anisotropic GGX NDF in the tangent frame (hx along the tangent, hy
    the bitangent, hz the normal)."""
    qx = hx / ax
    qy = hy / ay
    e = qx * qx + qy * qy + hz * hz
    return 1.0 / torch.clamp_min(PI * ax * ay * e * e, 1e-12)


def ggx_smith_g1_aniso(vx, vy, vz, ax, ay):
    """Smith G1 of the anisotropic GGX (Heitz 2014, the Λ form) from a
    direction's tangent-frame components."""
    vz2 = torch.clamp_min(vz * vz, 1e-12)
    lam = 0.5 * (torch.sqrt(1.0 + (ax * ax * vx * vx + ay * ay * vy * vy) / vz2) - 1.0)
    return torch.where(vz > 1e-6, 1.0 / (1.0 + lam), 0.0)


def sample_ggx_h_aniso(u1, u2, t, s, n, ax, ay):
    """An anisotropic-GGX half-vector about the (t, s, n) frame through
    slope space (pdf_h = D(h)·cos_h); equals sample_ggx_h's at ax == ay.
    Returns h (V3, world)."""
    r = torch.sqrt(torch.clamp(u1 / torch.clamp_min(1.0 - u1, 1e-12), 0.0, 1e12))
    phi = 2.0 * PI * u2
    sx = ax * r * torch.cos(phi)
    sy = ay * r * torch.sin(phi)
    inv = 1.0 / torch.sqrt(1.0 + sx * sx + sy * sy)
    return v3.add(v3.add(v3.scale(t, sx * inv), v3.scale(s, sy * inv)), v3.scale(n, inv))


def _fresnel(f0, oh):
    """Schlick's Fresnel with F0 = f0 (V3) at the cosine oh."""
    p5 = schlick5(1.0 - torch.clamp(oh, 0.0, 1.0))
    return tuple(f0[c] + (1.0 - f0[c]) * p5 for c in range(3))


def ggx_eval_aniso(n, t, s, wo, wi, f0, ax, ay):
    """Anisotropic GGX conductor BRDF and the pdf of sample_ggx_h_aniso-driven
    reflection (D·cos_h / (4·(wo·h))) in the frame (t, s, n) =
    build_onb(n): (f V3, pdf plane)."""
    h_raw = v3.add(wo, wi)
    hl = torch.clamp_min(v3.length(h_raw), 1e-12)
    h = v3.scale(h_raw, 1.0 / hl)

    def tf(v):
        return v3.dot(v, t), v3.dot(v, s), v3.dot(v, n)

    hx, hy, hz = tf(h)
    ox, oy, oz = tf(wo)
    ix, iy, iz = tf(wi)
    oh = v3.dot(wo, h)
    d = ggx_d_aniso(hx, hy, hz, ax, ay)
    g = ggx_smith_g1_aniso(ox, oy, oz, ax, ay) * ggx_smith_g1_aniso(ix, iy, iz, ax, ay)
    fres = _fresnel(f0, oh)
    denom = torch.clamp_min(4.0 * oz * iz, 1e-6)
    valid = (iz > 0.0) & (oz > 0.0) & (oh > 0.0)
    spec = torch.where(valid, d * g / denom, 0.0)
    pdf = torch.where(valid, d * torch.clamp_min(hz, 0.0) / torch.clamp_min(4.0 * oh, 1e-6), 0.0)
    return v3.scale(fres, spec), pdf


def ggx_eval(n, wo, wi, f0, alpha):
    """GGX conductor BRDF f(wo, wi) (Schlick Fresnel, F0 = f0; separable
    Smith masking) and the solid-angle pdf of sample_ggx_h-driven
    reflection: (f V3, pdf plane), both 0 where wi is under the surface."""
    h_raw = v3.add(wo, wi)
    hl = torch.clamp_min(v3.length(h_raw), 1e-12)
    h = v3.scale(h_raw, 1.0 / hl)
    cos_h = v3.dot(n, h)
    cos_o = v3.dot(n, wo)
    cos_i = v3.dot(n, wi)
    oh = v3.dot(wo, h)
    d = ggx_d(cos_h, alpha)
    g = ggx_smith_g1(cos_o, alpha) * ggx_smith_g1(cos_i, alpha)
    fres = _fresnel(f0, oh)
    denom = torch.clamp_min(4.0 * cos_o * cos_i, 1e-6)
    valid = (cos_i > 0.0) & (cos_o > 0.0) & (oh > 0.0)
    spec = torch.where(valid, d * g / denom, 0.0)
    pdf = torch.where(valid, d * torch.clamp_min(cos_h, 0.0) / torch.clamp_min(4.0 * oh, 1e-6),
                      0.0)
    return v3.scale(fres, spec), pdf
