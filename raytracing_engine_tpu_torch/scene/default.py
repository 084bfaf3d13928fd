"""The reference's hard-coded default scene.

The exact literals of reference src/main.rs:524-601 (4 materials, 4 spheres,
2 point lights), as in raytracing_engine_tpu/scene/default.py.
"""

from __future__ import annotations

from raytracing_engine_tpu_torch.scene.types import Scene, make_scene

# reference src/main.rs:524-557
DEFAULT_MATERIALS = (
    {"color": (0.2, 0.2, 1.0), "diffuse": 1.0, "specular": 1.0, "shine": 1.0, "ambient": 0.05},
    {"color": (0.1, 1.0, 0.1), "diffuse": 1.0, "specular": 1.0, "shine": 10.0, "ambient": 0.05},
    {"color": (1.0, 1.0, 0.1), "diffuse": 1.0, "specular": 1.0, "shine": 1.0, "ambient": 0.05},
    {"color": (1.0, 0.1, 0.1), "diffuse": 1.0, "specular": 1.0, "shine": 1.0, "ambient": 0.05},
)

# reference src/main.rs:559-576 — (pos, radius)
DEFAULT_OBJECTS = (
    ((5.0, 5.0, -1.0), 3.0),
    ((5.0, 4.0, 10.0), 6.0),
    ((-3.0, 3.0, -3.0), 1.0),
    ((4.0, -1.0, 0.0), 2.0),
)

# reference src/main.rs:578-591 — (pos, color); |color| = strength
DEFAULT_LIGHTS = (
    ((-1.0, 0.0, -3.0), (0.1, 0.5, 0.6)),
    ((8.0, -5.0, 10.0), (1.2, 0.2, 0.3)),
)


def default_scene(device=None) -> Scene:
    """The default scene on `device` (None: the CUDA card; raises without
    one)."""
    return make_scene(DEFAULT_OBJECTS, DEFAULT_MATERIALS, DEFAULT_LIGHTS, device)
