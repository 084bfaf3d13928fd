"""Phong shading with sphere-traced soft shadows (whole image).

The math of reference shaders/fragment.glsl:127-187: nearest-object lookup
(material paired by index, :144-156), camera and normal falloffs (:162-167),
per-light diffuse + specular with distance falloff and a soft-shadow factor
whose march starts 1.0 along the light direction (:170-186). Lights run one
after another over all MAX_LIGHTS slots; dead slots march no step and add 0.

As in the JAX package, the specular base is clamped to 0 before ``pow``
(GLSL pow is undefined for negative bases, fragment.glsl:47-50).
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.config import CAM_FALL_OFF, LIGHT_FALL_OFF, MAX_LIGHTS
from raytracing_engine_tpu_torch.ops.march import shadow_march
from raytracing_engine_tpu_torch.ops.sdf import dot3, scene_sdf_all


def _normalize(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def phong_shade(total_dist, direction, cam_pos, scene, render_dist: float,
                max_shadow_steps: int):
    """(..., 3) linear RGB for depths total_dist (...,) along unit directions
    (..., 3) from cam_pos (3,); rays with depth >= render_dist are black."""
    device = total_dist.device
    obj_mask = torch.arange(scene.obj_pos.shape[0], device=device) < scene.obj_count

    position = cam_pos + direction * total_dist[..., None]

    # nearest object by SDF; argmin takes the first minimum, as the strict
    # '<' scan at fragment.glsl:148-156 does
    dists = torch.where(obj_mask, scene_sdf_all(position, scene.obj_pos, scene.obj_radius),
                        torch.inf)
    idx = torch.argmin(dists, dim=-1)
    obj_pos = scene.obj_pos[idx]
    mat_color = scene.mat_color[idx]
    mat_shine = scene.mat_shine[idx]
    mat_ambient = scene.mat_ambient[idx]

    to_cam = position - cam_pos
    cam_dist = torch.sqrt(dot3(to_cam, to_cam))
    cam_fall = torch.clamp_min(CAM_FALL_OFF * (cam_dist * cam_dist + 1.0), 1.0)

    normal = _normalize(position - obj_pos)
    normal_fall = torch.clamp_min(dot3(normal, -direction), 0.0)

    # missed rays march no shadow step and come out black (fragment.glsl:137-140)
    hit_mask = total_dist < render_dist

    color = torch.zeros(position.shape, dtype=torch.float32, device=device)
    for slot in range(MAX_LIGHTS):
        light_live = slot < scene.light_count
        lpos = scene.light_pos[slot]
        lcol = scene.light_color[slot]

        to_light = lpos - position
        light_dist = torch.sqrt(dot3(to_light, to_light))
        light_dir = to_light / light_dist[..., None]

        end = torch.where(light_live & hit_mask, light_dist, 0.0)
        soft = shadow_march(
            position + light_dir,  # +1.0 offset — fragment.glsl:176
            light_dir, end, scene.obj_pos, scene.obj_radius, obj_mask,
            max_shadow_steps,
        )
        soft = torch.clamp_max(soft, 1.0)

        light_fall = torch.clamp_min(LIGHT_FALL_OFF * light_dist * light_dist, 1.0)
        diffuse = torch.clamp_min(dot3(normal, light_dir), 0.0)
        # reflect(-l, n) = -l - 2*dot(n, -l)*n
        refl = -light_dir - 2.0 * dot3(normal, -light_dir)[..., None] * normal
        base = torch.clamp_min(dot3(refl, -direction), 0.0)
        spec = torch.clamp_min(diffuse * torch.pow(base, mat_shine), 0.0)

        direct = (torch.clamp_min(diffuse + spec, 0.0)[..., None] * lcol
                  / light_fall[..., None] * soft[..., None])
        contrib = ((mat_ambient[..., None] + direct) / cam_fall[..., None]
                   * normal_fall[..., None] * mat_color)
        color = color + torch.where(light_live, contrib, 0.0)

    return torch.where(hit_mask[..., None], color, 0.0)
