"""Cone march and shadow march as whole-image masked loops.

The reference's data-dependent GLSL while-loops (compute.glsl:44-66,
fragment.glsl:99-119) become a Python loop over tensors of per-ray state with
an active-lane mask; the loop stops when no lane is active or at the step
bound. A lane is active from step 0 until it finishes, so each ray takes
min(its own convergence, max_steps) steps — the same count as one CUDA thread
marching that ray alone (csrc/conemarch.cuh). The algorithm-3 lazy SDF cache
(compute.glsl:51-57) is kept as selects, so trajectories match the reference
step for step.

These are the plain versions the CUDA kernels are held to; the loop reads
`.any()` back to the host once per step.

``steps`` sums, per loop, the steps every ray took since it was last set to
0 (a device tensor once counted): the march work that chip_smoke.py's
operation bound for the kernels K1-K3 counts.
"""

from __future__ import annotations

import torch

from raytracing_engine_tpu_torch.config import RAY_RADIUS
from raytracing_engine_tpu_torch.ops.sdf import scene_sdf_all

steps = {"march": 0, "shadow": 0}


def cone_march(origin, direction, threshold, obj_pos, obj_radius, obj_mask,
               render_dist: float, max_steps: int):
    """Algorithm-3 cone march → (...,) marched length.

    origin (..., 3) is the march start (already offset by the seed depth),
    direction (..., 3) unit, threshold the cone growth per unit length
    (compute.glsl:75), obj_mask (K,) the live slots. Per lane:
        while len < RENDER_DIST:
            radius = (len + 1) * threshold
            per object: cache -= last; if cache <= radius: cache = sdf(pos)
            dist = min(RENDER_DIST, min(cache))
            last = max(dist, 0); len += last
            if dist <= radius: len -= radius; break
    """
    big = render_dist
    cache = scene_sdf_all(origin, obj_pos, obj_radius)
    length = torch.zeros(origin.shape[:-1], dtype=torch.float32, device=origin.device)
    last = torch.zeros_like(length)
    done = torch.zeros(length.shape, dtype=torch.bool, device=origin.device)

    for _ in range(max_steps):
        active = ~done & (length < big)
        if not bool(active.any()):
            break
        steps["march"] = steps["march"] + active.sum()
        position = origin + direction * length[..., None]
        radius = (length + 1.0) * threshold
        bound = cache - last[..., None]
        fresh = scene_sdf_all(position, obj_pos, obj_radius)
        updated = torch.where(bound <= radius[..., None], fresh, bound)
        dist = torch.where(obj_mask, updated, big).amin(dim=-1)
        dist = torch.clamp_max(dist, big)

        new_last = torch.clamp_min(dist, 0.0)
        new_length = length + new_last
        hit = dist <= radius
        new_length = torch.where(hit, new_length - radius, new_length)

        length = torch.where(active, new_length, length)
        last = torch.where(active, new_last, last)
        cache = torch.where(active[..., None], updated, cache)
        done = done | (active & hit)
    return length


def shadow_march(origin, direction, end, obj_pos, obj_radius, obj_mask,
                 max_steps: int):
    """Soft-shadow march (fragment.glsl:89-121) → (...,) factor.

    origin is already offset +1.0 along the light direction; end (...,) is the
    cutoff (distance to the light; end <= 0 marches no step). Returns 0 where
    a step came within RAY_RADIUS of a surface, else the running minimum
    distance (init 1.0). The lazy-eval gate is that running minimum.
    """
    cache = scene_sdf_all(origin, obj_pos, obj_radius)
    length = torch.zeros(origin.shape[:-1], dtype=torch.float32, device=origin.device)
    last = torch.zeros_like(length)
    nearest = torch.ones_like(length)
    occluded = torch.zeros(length.shape, dtype=torch.bool, device=origin.device)

    for _ in range(max_steps):
        active = ~occluded & (length < end)
        if not bool(active.any()):
            break
        steps["shadow"] = steps["shadow"] + active.sum()
        position = origin + direction * length[..., None]
        bound = cache - last[..., None]
        fresh = scene_sdf_all(position, obj_pos, obj_radius)
        updated = torch.where(bound <= nearest[..., None], fresh, bound)
        dist = torch.where(obj_mask, updated, end[..., None]).amin(dim=-1)
        dist = torch.minimum(dist, end)

        hit = dist <= RAY_RADIUS
        new_last = torch.clamp_min(dist, 0.0)
        new_nearest = torch.minimum(nearest, dist)
        new_length = length + new_last + RAY_RADIUS

        # a lane that hits keeps nearest/length frozen; `occluded` decides
        advance = active & ~hit
        length = torch.where(advance, new_length, length)
        last = torch.where(advance, new_last, last)
        nearest = torch.where(advance, new_nearest, nearest)
        cache = torch.where(active[..., None], updated, cache)
        occluded = occluded | (active & hit)
    return torch.where(occluded, 0.0, nearest)
