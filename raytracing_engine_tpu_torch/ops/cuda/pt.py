"""K4: the sphere path tracer through the CUDA kernel ``pt_kernel``
(csrc/pt.cu), which replaces raytracing_engine_tpu/ops/pallas/pt_kernel.py
``_pt_kernel`` for scenes of spheres and up to TRI_UNROLL_MAX unrolled
triangles (BASELINE configs 2 and 4).

A scene on the CPU takes the plain version, ``render_pt_mega_reference``; a
scene on a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.ops.cuda import common
from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, to_int32
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig
from raytracing_engine_tpu_torch.pathtracer.scene import TRI_UNROLL_MAX, PTScene
from raytracing_engine_tpu_torch.pathtracer.wavefront import _trace_core, check_supported

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
launches = 0

# the kernel stages the scene tables in (static) shared memory
_MAX_TABLE_BYTES = 48 * 1024


class PTArgs(ctypes.Structure):
    """Mirror of ``pt::Args`` (csrc/pt.cuh), field for field."""

    _fields_ = [
        ("cam_pos", ctypes.c_void_p),
        ("cam_quat", ctypes.c_void_p),
        ("sph", ctypes.c_void_p),
        ("tri", ctypes.c_void_p),
        ("mat", ctypes.c_void_p),
        ("light", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("nrays", ctypes.c_void_p),
        ("S", ctypes.c_int),
        ("T", ctypes.c_int),
        ("M", ctypes.c_int),
        ("L", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("seed", ctypes.c_int),
        ("spp_offset", ctypes.c_int),
        ("max_bounces", ctypes.c_int),
        ("rr_start", ctypes.c_int),
        ("use_nee", ctypes.c_int),
        ("uniform_lights", ctypes.c_int),
        ("ratio_x", ctypes.c_float),
        ("ratio_y", ctypes.c_float),
        ("t_min", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("device", ctypes.c_int),
    ]


def pack_pt_scene(scene: PTScene):
    """The scene as kernel tables (ops/pallas/pt_kernel.py pack_pt_scene, the
    slice's columns): sph (S, 8) [pos, radius, mat, 0 x3]; tri (T, 12) [v0,
    e1, e2, mat, 0 x2]; mat (M, 8) [albedo, emission, kind, ior]; light
    (L, 12) [kind, prim, area, le, pick, cdf, total_power, 0 x3]; counts
    int32 (4,) [spheres, triangles, materials, lights]."""
    f32 = torch.float32
    S, T = scene.sph_pos.shape[0], scene.tri_v0.shape[0]
    M, L = scene.mat_albedo.shape[0], scene.light_kind.shape[0]
    dev = scene.device
    sph = torch.cat([scene.sph_pos, scene.sph_radius[:, None],
                     scene.sph_mat[:, None].to(f32), torch.zeros((S, 3), dtype=f32, device=dev)], 1)
    tri = torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat[:, None].to(f32),
                     torch.zeros((T, 2), dtype=f32, device=dev)], 1)
    mat = torch.cat([scene.mat_albedo, scene.mat_emission, scene.mat_kind[:, None].to(f32),
                     scene.mat_ior[:, None]], 1)
    light = torch.cat([scene.light_kind[:, None].to(f32), scene.light_prim[:, None].to(f32),
                       scene.light_area[:, None], scene.light_le, scene.light_pick[:, None],
                       scene.light_cdf[:, None], scene.light_total_power.expand(L, 1),
                       torch.zeros((L, 3), dtype=f32, device=dev)], 1)
    # torch.full, not torch.tensor: a host-to-device copy would block the
    # host until the stream drains, every call
    counts = torch.stack([scene.sph_count, scene.tri_count,
                          torch.full((), M, dtype=torch.int32, device=dev), scene.light_count])
    return sph.contiguous(), tri.contiguous(), mat.contiguous(), light.contiguous(), counts


def _prepare(cfg: PTConfig, scene: PTScene, row0: int, band_h):
    """The config the kernel renders (rng forced to pcg, as the JAX
    render_pt_mega does) and the band height, after the slice's checks."""
    if scene.tri_v0.shape[0] > TRI_UNROLL_MAX:
        raise ValueError(f"megakernel unrolls triangles; {scene.tri_v0.shape[0]} slots > "
                         f"{TRI_UNROLL_MAX}")
    if cfg.rng != "pcg":
        cfg = dataclasses.replace(cfg, rng="pcg")
    check_supported(cfg)
    h = band_h or cfg.height
    if not 0 <= row0 <= cfg.height - h:
        raise ValueError(f"band rows {row0}..{row0 + h} outside the {cfg.height}-row image")
    return cfg, h


def render_pt_mega_reference(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                             seed: int = 0, spp_offset: int = 0, row0: int = 0, band_h=None):
    """Plain PyTorch version: the wavefront core per pass, passes summed in
    pass order and then scaled by 1/spp (ops/pallas/pt_kernel.py:360-363).
    → ((band_h or H, W, 3) image, nrays int64)."""
    cfg, h = _prepare(cfg, scene, row0, band_h)
    acc = torch.zeros((h, cfg.width, 3), dtype=torch.float32, device=scene.device)
    nrays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(spp):
        rad, n = _trace_core(cfg, scene, cam_pos, cam_quat, pass_seed(seed, spp_offset + s),
                             row0=row0, band_h=h)
        acc = acc + torch.stack(rad, dim=-1)
        nrays = nrays + n
    inv = float(np.float32(1.0) / np.float32(spp))
    return acc * inv, nrays


def render_pt_mega(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                   seed: int = 0, spp_offset: int = 0, row0: int = 0, band_h=None):
    """Megakernel render: ((band_h or H, W, 3) image, nrays int64 0-dim).

    seed: the int32 base seed (ops.rng_pcg.seed_from_int(1) matches
    jax.random.PRNGKey(1)); pass s uses the global pass index
    spp_offset + s. row0/band_h: render only rows row0 .. row0 + band_h - 1
    of the cfg.height image; a band equals the same rows of the full render,
    since the camera and the stream are keyed on global pixel coordinates.
    """
    global launches
    if scene.device.type == "cpu":
        return render_pt_mega_reference(cfg, scene, cam_pos, cam_quat, spp, seed,
                                         spp_offset, row0, band_h)
    cfg, h = _prepare(cfg, scene, row0, band_h)
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"scene on {device}: the CUDA kernels need a CUDA device")
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    f32 = torch.float32
    common.check(cam_pos, "cam_pos", (3,), f32, device)
    common.check(cam_quat, "cam_quat", (4,), f32, device)
    sph, tri, mat, light, counts = pack_pt_scene(scene)
    table_bytes = 4 * (sph.numel() + tri.numel() + mat.numel() + light.numel())
    if table_bytes > _MAX_TABLE_BYTES:
        raise ValueError(f"scene tables of {table_bytes} B exceed the kernel's "
                         f"{_MAX_TABLE_BYTES} B of shared memory")
    out = torch.empty((h, cfg.width, 3), dtype=f32, device=device)
    nrays = torch.zeros((1,), dtype=torch.int64, device=device)
    args = PTArgs(
        cam_pos=cam_pos.data_ptr(), cam_quat=cam_quat.data_ptr(),
        sph=sph.data_ptr(), tri=tri.data_ptr(), mat=mat.data_ptr(), light=light.data_ptr(),
        counts=counts.data_ptr(), out=out.data_ptr(), nrays=nrays.data_ptr(),
        S=sph.shape[0], T=tri.shape[0], M=mat.shape[0], L=light.shape[0],
        width=cfg.width, height=cfg.height, w=cfg.width, h=h, row0=row0,
        spp=spp, seed=to_int32(seed), spp_offset=to_int32(spp_offset),
        max_bounces=cfg.max_bounces, rr_start=cfg.rr_start, use_nee=int(cfg.use_nee),
        uniform_lights=int(cfg.light_sampling == "uniform"),
        ratio_x=cfg.ratio[0], ratio_y=cfg.ratio[1], t_min=cfg.t_min, eps=cfg.eps,
        device=device.index if device.index is not None else torch.cuda.current_device(),
    )
    common.launch("pt_render", args, name="pt")
    launches += 1
    return out, nrays[0]
