"""AOV (arbitrary output variable) buffers: first-hit albedo, shading
normal, and depth, averaged over jittered primary samples
(raytracing_engine_tpu/pathtracer/aov.py).

Denoisers (OIDN/OptiX-style) and compositing pipelines consume these
guide planes alongside the noisy radiance; the reference has no analog (it
draws directly to the swapchain). One intersection pass per sample,
through the path tracer's own intersectors (``wavefront._intersect``: the
unrolled slots, or a mesh), so the AOVs are consistent with what the path
tracer hits, including the two-sided normal orientation and the
per-triangle materials. On a CUDA scene the jitter is drawn by kernel K9
(ops/cuda/rng.uniform_key) and the mesh is walked by K6 (a ClusterSet), K8
(a raw BVH) or K7 (an InstancedClusters); on a CPU scene their plain
versions run.

Misses write zeros into every plane (depth 0 is the conventional "sky"
sentinel: a real hit has depth >= t_min > 0). The albedo follows checkers
(world or UV space) and image textures at the hit's UV, as the JAX
package's does (the denoiser demodulates by it; bilinear where
cfg.tex_filter says "bilinear", else nearest, as in JAX aov.py:64-68). The
normal guide is the shading normal: the geometric one, perturbed by the
material's normal map where the scene has one (JAX aov.py:70-79).
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.device import common
from raytracing_engine_tpu_torch.ops import vec3 as v3
from raytracing_engine_tpu_torch.ops.cuda import rng as krng
from raytracing_engine_tpu_torch.ops.rng import fold_in, key_words
from raytracing_engine_tpu_torch.pathtracer import sampler
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig
from raytracing_engine_tpu_torch.pathtracer.scene import PTScene
from raytracing_engine_tpu_torch.pathtracer.wavefront import (
    _camera_rays,
    _counts,
    _intersect,
    _mat_lookup,
    _occluded,
    _perturb_normal,
    _textured_albedo,
    check_entry,
    check_mesh,
)


def render_aovs(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                key=None, bvh=None, ao_radius: float = 0.0):
    """First-hit AOVs for denoising: dict with albedo (H, W, 3), normal
    (H, W, 3) (two-sided, unit, world space) and depth (H, W) (ray
    parameter t, 0 on miss), on the scene's device; all spp-averaged with
    the sub-pixel jitter of the JAX package: sample i draws
    jax.random.uniform(fold_in(fold_in(key, i), 0), (n, H, W)). key: see
    ops/rng.py (None: PRNGKey(0)). Always the pinhole view: denoiser
    guides want the sharp geometry even when the beauty pass uses depth of
    field. cam_pos and cam_quat go to the scene's device when they are not
    tensors; a tensor on another device raises ValueError.

    ao_radius > 0 adds an ``ao`` (H, W) plane: cosine-weighted hemisphere
    occlusion within that world-space radius (1 = fully open, spp any-hit
    probes per pixel; misses/sky read 1)."""
    check_mesh(bvh)
    check_entry(scene, bvh)
    dev = common(cam_pos, cam_quat, scene.sph_pos)
    cam_pos, cam_quat = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (cam_pos, cam_quat))
    words = key_words(0 if key is None else key)
    h, w = cfg.height, cfg.width
    want_ao = ao_radius > 0.0
    n_u = 4 if want_ao else 2
    counts = _counts(scene)

    zero = torch.zeros((h, w), dtype=torch.float32, device=dev)
    alb, nrm, dep, ao = (zero, zero, zero), (zero, zero, zero), zero, zero
    for i in range(spp):
        u = krng.uniform_key(fold_in(fold_in(words, i), 0), n_u, h, w, device=dev)
        o, d = _camera_rays(cfg, cam_pos, cam_quat, u[0], u[1])
        isect = _intersect(scene, o, d, cfg.t_min, counts, bvh)
        hit = isect["hit"]
        gate = torch.where(hit, 1.0, 0.0)
        albedo = _mat_lookup(scene, isect["mat_id"])[0]
        if scene.has_texture:  # textured albedo: the denoiser demodulates by it
            albedo = _textured_albedo(scene, isect["mat_id"], albedo, isect["p"],
                                      uv=isect.get("uv"),
                                      bilinear=cfg.tex_filter == "bilinear")
        shade_n = isect["n"]
        if scene.has_normal_map:  # the guide is the perturbed shading normal
            shade_n = _perturb_normal(scene, isect["mat_id"], shade_n, isect["tan"], isect["uv"],
                                      bilinear=cfg.tex_filter == "bilinear")
        alb = v3.add(alb, v3.scale(albedo, gate))
        nrm = v3.add(nrm, v3.scale(shade_n, gate))
        dep = dep + torch.where(hit, isect["t"], 0.0)
        if want_ao:
            probe_d, _ = sampler.cosine_hemisphere(u[2], u[3], isect["n"])
            probe_o = v3.add(isect["p"], v3.scale(isect["n"], cfg.eps))
            blocked = _occluded(scene, probe_o, probe_d, torch.full((h, w), ao_radius, device=dev),
                                cfg.t_min, counts, bvh)
            # misses count as open; sky pixels stay fully open
            ao = ao + torch.where(hit & blocked, 0.0, 1.0)

    inv = 1.0 / spp
    # re-normalize the averaged normal (an average of unit vectors is not
    # unit at silhouette pixels); zero stays zero
    nlen = torch.clamp_min(v3.length(nrm), 1e-20)
    nrm = v3.scale(nrm, torch.where(nlen > 1e-6, 1.0 / nlen, 0.0))
    out = dict(albedo=torch.stack([p * inv for p in alb], dim=-1),
               normal=torch.stack(list(nrm), dim=-1),
               depth=dep * inv)
    if want_ao:
        out["ao"] = ao * inv
    return out
