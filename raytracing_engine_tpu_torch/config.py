"""Static render configuration.

A pure-Python copy of ``raytracing_engine_tpu/config.py``: importing that
module pulls in JAX (through the package ``__init__``), and this package
never imports JAX. The pyramid geometry (``level_count``, ``level_dims``,
``level_image_size``, ``level_threshold``, ``ratio``) is identical, so both
packages march the same levels; the tests hold the two to each other.

The reference keeps these as compile-time constants (reference
src/main.rs:359-364). The TPU-only tile caps of the JAX config are not kept:
the CUDA kernels run one thread per pixel.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

# Fixed capacities — reference shaders/utilities.glsl:2-4. Scenes are padded
# to these and masked by counts.
MAX_MATERIALS = 8
MAX_OBJECTS = 8
MAX_LIGHTS = 8

# Shading constants — reference shaders/fragment.glsl:35-37.
CAM_FALL_OFF = 0.01
LIGHT_FALL_OFF = 0.01
RAY_RADIUS = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Hashable configuration for one renderer specialization.

    width/height: output resolution in pixels (the reference window size).
    render_dist:  ray cutoff distance (reference src/main.rs:362).
    fov:          field-of-view scale (reference src/main.rs:364); the
                  per-axis NDC multiplier is [fov, fov*h/w].
    max_march_steps / max_shadow_steps: trip limits for the data-dependent
                  GLSL while-loops (compute.glsl:44, fragment.glsl:99).
    """

    width: int = 512
    height: int = 512
    render_dist: float = 1000.0
    fov: float = 1.0
    max_march_steps: int = 256
    max_shadow_steps: int = 256

    def __post_init__(self):
        if self.width % 8 or self.height % 8:
            raise ValueError(
                "width/height must be multiples of 8 (the reference rounds "
                "the finest pyramid level up to a multiple of 8; we require "
                "it so every level maps exactly onto the output)"
            )
        if self.height > self.width:
            # reference enforces width >= height on resize (src/main.rs:698-709)
            raise ValueError("height must be <= width")

    # ---- depth pyramid geometry (reference src/main.rs:203-234) ------------

    @cached_property
    def level_count(self) -> int:
        return int(math.ceil(math.log2(self.width / 8.0))) + 1

    @cached_property
    def level_dims(self) -> tuple[tuple[int, int], ...]:
        """(width, height) per pyramid level, coarse → fine:
        ratio = res / (4 << N); dims_i = ceil(2^i * ratio) * 8."""
        n = self.level_count
        rx = self.width / float(4 << n)
        ry = self.height / float(4 << n)
        return tuple(
            (int(math.ceil((1 << i) * rx)) * 8, int(math.ceil((1 << i) * ry)) * 8)
            for i in range(n)
        )

    def level_image_size(self, i: int) -> tuple[float, float]:
        """Per-level ``imageSize`` push constant: 2^(N-1-i) / window size
        (reference src/main.rs:301-307)."""
        s = float(1 << (self.level_count - 1 - i))
        return (s / self.width, s / self.height)

    def level_threshold(self, i: int) -> float:
        """Cone threshold: sqrt(2) * workgroup(8) * imageSize.x
        (reference compute.glsl:75)."""
        return math.sqrt(2.0) * 8.0 * self.level_image_size(i)[0]

    @cached_property
    def ratio(self) -> tuple[float, float]:
        """NDC→camera-plane multiplier [FOV, FOV*h/w] (reference src/main.rs:610)."""
        return (self.fov, self.fov * self.height / self.width)

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)
