"""Path-tracer configuration (raytracing_engine_tpu/pathtracer/integrator.py).

``PTConfig`` is copied with every field and default, so a configuration
means the same in both packages. The port renders the three streams
(threefry, pcg, pallas), pinhole camera, NEE with power or uniform light
selection, Russian roulette and nearest texture filtering; the other fields
are carried and refused where they change the render (pathtracer/
wavefront.py). The stacked cross-check integrator (``render_pt``) is still
to port (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import dataclasses


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
