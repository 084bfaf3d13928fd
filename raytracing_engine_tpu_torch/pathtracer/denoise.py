"""Edge-aware à-trous wavelet denoiser guided by the AOV planes
(raytracing_engine_tpu/pathtracer/denoise.py).

Single-frame SVGF-lite: the low-spp radiance is demodulated by the
first-hit albedo (so texture detail never blurs), filtered by N à-trous
passes of the 5x5 B3-spline kernel with stride 2^i, each tap weighted by
AOV-edge stopping functions (normal alignment, relative depth, radiance
luminance), then remodulated. This is the standard real-time pattern
(render 1-8 spp, denoise): Dammertz et al. 2010 "Edge-Avoiding À-Trous
Wavelet Transform", the spatial core of SVGF.

Plain PyTorch on the device of its inputs: the JAX package leaves this
module to XLA (it has no Pallas kernel), so it has no CUDA kernel here
either. Every expression keeps the JAX operation order: the taps in ``ky``
then ``kx`` order, each weight as ``hk * w_n * w_d * w_l * q_hit``, and
``wsum`` and ``acc`` summed tap by tap. Edges clamp: a tap reads the
nearest pixel inside the image (one index gather per axis, over the planes
stacked, which moves values without rounding them).
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.device import common

# 1D B3-spline [1, 4, 6, 4, 1] / 16 -> 5x5 outer product
_K1 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _log_lum(r, g, b):
    return torch.log1p(0.2126 * r + 0.7152 * g + 0.0722 * b)


def demod_log_lum(radiance, albedo, *, device=None):
    """log1p luminance of albedo-demodulated radiance: the domain every
    noise/edge statistic in this module (and the temporal moments in
    temporal.py) lives in. Emissive/sky pixels (albedo ~0) skip
    demodulation (see the epsilon-divide hazard note in denoise)."""
    dev = common(radiance, albedo, device=device)
    rad, alb = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (radiance, albedo))
    demod = torch.amax(alb, dim=-1, keepdim=True) > 0.05
    safe = torch.where(demod, torch.clamp_min(alb, 1e-3), 1.0)
    irr = rad / safe
    return _log_lum(irr[..., 0], irr[..., 1], irr[..., 2])


def _shifter(h: int, w: int, device):
    """shift(planes, dy, dx): result[..., y, x] = planes[..., clamp(y - dy),
    clamp(x - dx)] (JAX _shift's edge padding; direction is irrelevant, the
    kernel sums symmetric offsets)."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)

    def shift(planes, dy: int, dx: int):
        iy = torch.clamp(ys - dy, 0, h - 1)
        ix = torch.clamp(xs - dx, 0, w - 1)
        return planes.index_select(-2, iy).index_select(-1, ix)

    return shift


def denoise(radiance, albedo, normal, depth, iterations: int = 4,
            sigma_lum: float = 0.7, sigma_n: float = 64.0,
            sigma_d: float = 0.05, firefly_k: float = 8.0, noise=None, *, device=None):
    """Denoise (H, W, 3) radiance using render_aovs() guide planes.

    radiance/albedo/normal: (H, W, 3); depth: (H, W) with 0 = sky. Computed
    on the device of the tensor inputs; numpy inputs go there, or to
    ``device`` (None: the CUDA card) when no input is a tensor; inputs on
    two devices raise ValueError.

    iterations: à-trous passes (stride 1, 2, 4, ...); effective kernel
    footprint is ~4*2^iterations pixels. The luminance edge-stop works in
    log1p space (relative differences: a 15x light next to a 1x wall is
    a hard edge at any exposure) and is normalized by a center-excluded
    3x3 local std of the DEMODULATED input (SVGF's trick): weights then
    measure edges in units of the noise, so one sigma_lum works across
    spp counts; bigger = smoother. sigma_n is the normal cosine power
    (bigger = stricter geometry edges), sigma_d the relative-depth
    tolerance, firefly_k the outlier pre-clamp (local mean + k*std).
    Sky pixels (depth 0) pass through untouched.

    noise: optional (H, W) override of the local noise estimate, in
    log1p-demodulated-luminance units (demod_log_lum): pass
    temporal.temporal_noise(state) for SVGF-style temporally-estimated
    variance (tighter than the single-frame 3x3 estimate once a few
    frames of history exist)."""
    dev = common(radiance, albedo, normal, depth, noise, device=device)
    rad, alb, nrm, dep = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in (radiance, albedo, normal, depth))
    h, w = dep.shape
    shift = _shifter(h, w, dev)

    hit = dep > 0.0
    # demodulate so albedo texture never blurs, but ONLY where albedo is
    # meaningful: emissive surfaces have albedo ~0, and dividing by an
    # epsilon there would scale their radiance by ~1000x and bleed it
    # into any neighbour the edge-stops let through. Identity there.
    demod = torch.amax(alb, dim=-1, keepdim=True) > 0.05
    safe_alb = torch.where(demod, torch.clamp_min(alb, 1e-3), 1.0)
    irr = [rad[..., c] / safe_alb[..., c] for c in range(3)]
    n = [nrm[..., c] for c in range(3)]
    rel = torch.clamp_min(dep, 1e-3)  # relative-depth scale

    # local noise scale: 3x3 std of the input's demodulated luminance,
    # EXCLUDING the center: including it would let a firefly inflate its
    # own noise estimate and dodge the clamp below
    lum0 = _log_lum(*irr)
    m1 = torch.zeros_like(lum0)
    m2 = torch.zeros_like(lum0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            q = shift(lum0, dy, dx)
            m1 = m1 + q
            m2 = m2 + q * q
    m1, m2 = m1 / 8.0, m2 / 8.0  # exact: a power of two
    local_noise = torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0)) + 1e-3
    if noise is None:
        noise = local_noise
    else:
        # override where it carries signal (temporal_noise returns 0 on
        # pixels without enough history); local estimate elsewhere
        ov = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        noise = torch.where(ov > 0.0, torch.clamp_min(ov, 1e-3), local_noise)

    # firefly pre-clamp: cap demodulated luminance at local mean + k*std
    # (outlier energy is unrecoverable spatially and dominates error).
    # Always the LOCAL std: a firefly is a spatial outlier, and temporal
    # variance AT the firefly is exactly what cannot be trusted.
    cap = m1 + firefly_k * local_noise  # in log1p-luminance units
    scale = torch.clamp_max(torch.expm1(cap) / torch.clamp_min(torch.expm1(lum0), 1e-20), 1.0)
    irr = [p * scale for p in irr]

    # the planes every tap reads, shifted together: irradiance (3), normal
    # (3), depth, the hit gate and the luminance of the irradiance (q_lum
    # is the shifted lum: the same function of the same values)
    gate = torch.where(hit, 1.0, 0.0)
    for it in range(iterations):
        s = 1 << it
        acc = [torch.zeros_like(irr[0]) for _ in range(3)]
        wsum = torch.zeros_like(irr[0])
        lum = _log_lum(*irr)
        planes = torch.stack(irr + n + [dep, gate, lum])
        for ky in range(5):
            for kx in range(5):
                hk = _K1[ky] * _K1[kx]
                q = shift(planes, (ky - 2) * s, (kx - 2) * s)
                q_irr, q_n, q_dep, q_hit, q_lum = q[0:3], q[3:6], q[6], q[7], q[8]
                # edge-stopping weights
                ndot = torch.clamp_min(n[0] * q_n[0] + n[1] * q_n[1] + n[2] * q_n[2], 0.0)
                w_n = ndot ** sigma_n
                w_d = torch.exp(-torch.abs(dep - q_dep) / (sigma_d * rel))
                w_l = torch.exp(-torch.abs(lum - q_lum) / (sigma_lum * noise))
                wt = hk * w_n * w_d * w_l * q_hit
                wsum = wsum + wt
                for c in range(3):
                    acc[c] = acc[c] + q_irr[c] * wt
        irr = [torch.where(hit, a / torch.clamp_min(wsum, 1e-20), p) for a, p in zip(acc, irr)]

    out = torch.stack([irr[c] * safe_alb[..., c] for c in range(3)], dim=-1)
    return torch.where(hit[..., None], out, rad)
