"""Temporal reprojection accumulation for animated low-spp sequences
(raytracing_engine_tpu/pathtracer/temporal.py).

The production real-time pattern's second half (the first half is the
spatial filter in denoise.py): each frame renders a few spp, and every
pixel's history from previous frames is REPROJECTED through the camera
motion and blended in: a static scene point keeps accumulating samples
across frames, so an orbiting camera converges like a progressive render
instead of starting from scratch every frame. Disocclusions (no valid
history) fall back to the current frame and rebuild history.

Reprojection math inverts the engine's camera model (compute.glsl:71-77
NDC mapping; Z-up, Y-forward): world hit point from the depth AOV ->
rotate into the PREVIOUS camera frame (conjugate quaternion) ->
perspective divide by the forward (y) component -> pixel coordinates ->
bilinear sample of the history planes. Validity = in-bounds, history
depth consistent with the reprojected point's distance, and normals
aligned; failing any resets that pixel's history length to zero.

Plain PyTorch on the device of its inputs (the JAX package leaves it to
XLA; it has no Pallas kernel), every expression in the JAX order; divisions
by a Python number go through ops/vec3.div, which keeps IEEE division on
the card. The depth gradient wraps at the image edge (``torch.roll``), as
the JAX package's ``jnp.roll`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_engine_tpu_torch.device import common, resolve
from raytracing_engine_tpu_torch.ops.quaternion import quat_rotate
from raytracing_engine_tpu_torch.ops.vec3 import div
from raytracing_engine_tpu_torch.pathtracer.denoise import demod_log_lum
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig


@dataclasses.dataclass
class TemporalState:
    irr: torch.Tensor       # (H, W, 3) accumulated radiance history
    depth: torch.Tensor     # (H, W) history depth (current frame's, post-blend)
    normal: torch.Tensor    # (H, W, 3) history normals
    length: torch.Tensor    # (H, W) effective history length (frames)
    cam_pos: torch.Tensor   # (3,) previous camera position
    cam_quat: torch.Tensor  # (4,) previous camera quaternion
    # SVGF-style temporal moments of the per-FRAME demodulated log1p
    # luminance (denoise.demod_log_lum units): same 1/(n+1) blend as
    # irr, so m2-m1^2 is the sample variance of the frames seen
    m1: torch.Tensor        # (H, W)
    m2: torch.Tensor        # (H, W)


def temporal_init(cfg: PTConfig, device=None) -> TemporalState:
    """An empty history on ``device`` (None: the CUDA card)."""
    dev = resolve(device)
    h, w = cfg.height, cfg.width

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return TemporalState(
        irr=zeros(h, w, 3), depth=zeros(h, w), normal=zeros(h, w, 3), length=zeros(h, w),
        cam_pos=zeros(3), cam_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
        m1=zeros(h, w), m2=zeros(h, w))


def _norm3(v):
    """|v| over the last axis of size 3, summed in index order. The square
    root is taken in float64 and rounded once to float32, which is the
    correctly rounded float32 root, as JAX's: PyTorch's float32 sqrt on CUDA
    is off by one bit on about 0.7% of inputs, and the reprojection turns a
    last-bit change of a pixel coordinate into a jump between neighbouring
    history pixels."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                       + v[..., 2] * v[..., 2]).double()).float()


def _world_points(cfg: PTConfig, depth, cam_pos, cam_quat):
    """Pixel-center world hit points from the depth AOV (t along the ray)."""
    h, w = depth.shape
    ix = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    iy = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    ncx = (div((ix + 0.5) * 2.0, w) - 1.0) * cfg.ratio[0]
    ncy = (div((iy + 0.5) * 2.0, h) - 1.0) * cfg.ratio[1]
    v = torch.stack([ncx * torch.ones_like(ncy), torch.ones_like(ncx * ncy),
                     ncy * torch.ones_like(ncx)], dim=-1)
    d = quat_rotate(cam_quat, v)
    d = d / _norm3(d)[..., None]
    return cam_pos + d * depth[..., None]


def _project(cfg: PTConfig, p_world, cam_pos, cam_quat):
    """World points -> (fy, fx) continuous pixel coords + camera distance
    in the given camera (inverse of the compute.glsl:71-77 mapping)."""
    h, w = p_world.shape[:2]
    conj = cam_quat * torch.tensor([-1.0, -1.0, -1.0, 1.0], device=cam_quat.device)
    pc = quat_rotate(conj, p_world - cam_pos)  # camera frame: y forward
    fwd = torch.clamp_min(pc[..., 1], 1e-6)
    ncx = div(pc[..., 0] / fwd, cfg.ratio[0])
    ncy = div(pc[..., 2] / fwd, cfg.ratio[1])
    fx = div((ncx + 1.0) * w, 2.0) - 0.5
    fy = div((ncy + 1.0) * h, 2.0) - 0.5
    return fy, fx, _norm3(pc)


def _bilinear(img, fy, fx):
    """Bilinear sample of (H, W, ...) planes at continuous coords. Indices
    are clamped before the float -> int conversion (JAX's conversion
    saturates; PyTorch's is undefined out of range), then again after it
    (NaN)."""
    h, w = img.shape[:2]
    x0 = torch.clamp(torch.floor(fx).clamp(0, w - 1).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).clamp(0, h - 1).to(torch.int64), 0, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    wx = torch.clamp(fx - x0, 0.0, 1.0)
    wy = torch.clamp(fy - y0, 0.0, 1.0)
    if img.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]

    def g(yy, xx):
        return img[yy, xx]

    return ((g(y0, x0) * (1 - wx) + g(y0, x1) * wx) * (1 - wy)
            + (g(y1, x0) * (1 - wx) + g(y1, x1) * wx) * wy)


def temporal_step(cfg: PTConfig, state: TemporalState, radiance, aovs,
                  cam_pos, cam_quat, max_history: int = 32,
                  depth_tol: float = 0.05, normal_tol: float = 0.9, *, device=None):
    """Blend one frame into the reprojected history.

    radiance: (H, W, 3) this frame's (low-spp) render from (cam_pos,
    cam_quat); aovs: render_aovs() dict for the SAME pose. Returns
    (new_state, accumulated image). Blend weight is 1/(len+1) capped at
    1/max_history: a static camera reproduces the running mean exactly
    (progressive-accumulation semantics) until the cap, then becomes an
    EMA that adapts to slow lighting change. Computed on the device of the
    state and the tensor inputs; numpy inputs go there (``device`` must
    name the same one, or is None); inputs on two devices raise
    ValueError."""
    dev = common(radiance, aovs["depth"], aovs["normal"], aovs["albedo"], cam_pos, cam_quat,
                 *vars(state).values(), device=device)
    rad, dep, nrm, alb, cam_pos, cam_quat = (
        torch.as_tensor(x, dtype=torch.float32, device=dev)
        for x in (radiance, aovs["depth"], aovs["normal"], aovs["albedo"], cam_pos, cam_quat))
    h, w = dep.shape

    p_world = _world_points(cfg, dep, cam_pos, cam_quat)
    fy, fx, prev_dist = _project(cfg, p_world, state.cam_pos, state.cam_quat)

    hist_irr = _bilinear(state.irr, fy, fx)
    hist_dep = _bilinear(state.depth, fy, fx)
    hist_nrm = _bilinear(state.normal, fy, fx)
    hist_len = _bilinear(state.length, fy, fx)
    hist_m1 = _bilinear(state.m1, fy, fx)
    hist_m2 = _bilinear(state.m2, fy, fx)

    in_bounds = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    # the history depth is the PREVIOUS camera's ray length to the same
    # surface point: compare against this frame's point distance to the
    # previous camera. The tolerance scales with the local depth GRADIENT
    # (SVGF's rule): on grazing surfaces one pixel of reprojection or AA
    # jitter legitimately moves depth by |grad z|, and a flat relative
    # tolerance would reject half the ground plane.
    gx = torch.abs(dep - torch.roll(dep, 1, dims=1))
    gy = torch.abs(dep - torch.roll(dep, 1, dims=0))
    grad = torch.maximum(gx, gy)
    depth_ok = torch.abs(hist_dep - prev_dist) <= (
        depth_tol * torch.clamp_min(prev_dist, 1e-3) + 4.0 * grad)
    ndot = (hist_nrm[..., 0] * nrm[..., 0] + hist_nrm[..., 1] * nrm[..., 1]
            + hist_nrm[..., 2] * nrm[..., 2])
    normal_ok = ndot >= normal_tol * torch.clamp_min(_norm3(hist_nrm), 1e-6)
    hit = dep > 0.0
    valid = in_bounds & depth_ok & normal_ok & hit & (hist_len > 0.0)

    n_eff = torch.where(valid, torch.clamp_max(hist_len, float(max_history - 1)), 0.0)
    alpha = 1.0 / (n_eff + 1.0)
    out = torch.where(
        hit[..., None],
        hist_irr * (1.0 - alpha[..., None]) + rad * alpha[..., None],
        rad)  # sky: always the fresh frame

    # temporal moments of the per-frame demodulated log luminance (same
    # blend weights): variance feeds the spatial filter's edge-stops
    # (temporal_noise)
    lum_f = demod_log_lum(rad, alb)
    m1 = hist_m1 * (1.0 - alpha) + lum_f * alpha
    m2 = hist_m2 * (1.0 - alpha) + lum_f * lum_f * alpha
    new_state = TemporalState(
        irr=out, depth=dep, normal=nrm,
        length=torch.where(hit, n_eff + 1.0, 0.0),
        cam_pos=cam_pos, cam_quat=cam_quat,
        m1=torch.where(hit, m1, 0.0), m2=torch.where(hit, m2, 0.0))
    return new_state, out


def temporal_noise(state: TemporalState, min_history: float = 4.0):
    """(H, W) noise plane for denoise(noise=...): the temporally-estimated
    standard error of the ACCUMULATED mean, sqrt(var/len), in
    demod_log_lum units. Pixels with fewer than min_history frames return
    0, and denoise(noise=...) falls back to its own single-frame local
    estimate exactly there (SVGF's construction)."""
    var = torch.clamp_min(state.m2 - state.m1 * state.m1, 0.0)
    se = torch.sqrt(var / torch.clamp_min(state.length, 1.0))
    return torch.where(state.length >= min_history, se, 0.0)
