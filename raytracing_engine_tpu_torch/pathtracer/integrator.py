"""Path-tracer configuration (raytracing_engine_tpu/pathtracer/integrator.py).

``PTConfig`` is copied with every field and default, so a configuration
means the same in both packages; pathtracer/wavefront.py renders every one
of them. ``tree_cluster_weights`` is the vectorised light-tree weight, the
cross-check of wavefront._tree_cluster_weights. The stacked cross-check
integrator (``render_pt``) is still to port (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PTConfig:
    width: int = 800
    height: int = 600
    fov: float = 1.0
    max_bounces: int = 4
    t_min: float = 1e-3
    eps: float = 1e-3          # shadow/scatter origin offset along the normal
    use_nee: bool = True
    # thin-lens depth of field: aperture = lens radius in world units
    # (0 = pinhole, the default); focus_dist = distance of the sharp plane
    aperture: float = 0.0
    focus_dist: float = 10.0
    # Russian roulette from bounce index rr_start on (0 = off): continue with
    # probability p = clamp(max(throughput), 0.05, 1), divide throughput by p
    rr_start: int = 0
    # "random" or "r2" (low-discrepancy camera and bounce-0 NEE dims)
    sampler: str = "random"
    # NEE light selection: "power" (area * luminance), "uniform", or "tree"
    light_sampling: str = "power"
    # homogeneous fog (0 = off) and its single-scatter coefficient
    fog_density: float = 0.0
    fog_color: tuple = (0.0, 0.0, 0.0)
    fog_scatter: float = 0.0
    # "threefry", "pcg" or "pallas" (the megakernels render "pcg")
    rng: str = "threefry"
    # "nearest", "bilinear" or "trilinear" atlas filtering
    tex_filter: str = "nearest"

    @property
    def ratio(self):
        return (self.fov, self.fov * self.height / self.width)


def tree_cluster_weights(scene, p3):
    """Light-tree cluster weights at (..., 3) points (JAX
    integrator.tree_cluster_weights): the (..., C) weights power_c /
    max(dist², radius_c², 1e-12) and their sum, each summed in order. In
    JAX its caller is the stacked integrator render_pt, which the port has
    not ported yet (ROADMAP queue 1 item 5); until then the tests hold the
    wavefront's per-ray weights (wavefront._tree_cluster_weights) to it."""
    d = p3[..., None, :] - scene.lt_center
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    floor = torch.maximum(d2, scene.lt_radius * scene.lt_radius)
    w = scene.lt_power / torch.clamp_min(floor, 1e-12)
    total = w[..., 0]
    for c in range(1, w.shape[-1]):
        total = total + w[..., c]
    return w, total
