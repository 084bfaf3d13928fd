"""Frame throughput metrics.

Rays traced per frame (primary = every pyramid-level pixel; secondary = one
shadow ray per live light per output pixel) and the derived Mrays/s.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FrameStats:
    """Ray accounting for one rendered frame."""

    primary_rays: int      # pyramid pixels (all levels)
    secondary_rays: int    # shadow rays launched
    seconds: float

    @property
    def total_rays(self) -> int:
        return self.primary_rays + self.secondary_rays

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / self.seconds / 1e6

    @property
    def fps(self) -> float:
        return 1.0 / self.seconds


def conemarch_ray_count(cfg, num_lights: int) -> tuple[int, int]:
    """(primary, secondary) rays per frame for the cone-march renderer.

    Primary: one march per pixel per pyramid level (every level is marched
    every frame, reference src/main.rs:300-316). Secondary: one shadow ray per
    live light per output pixel (fragment.glsl:170-176).
    """
    primary = sum(w * h for (w, h) in cfg.level_dims)
    secondary = cfg.width * cfg.height * num_lights
    return primary, secondary
