"""Scene as a structure of tensors.

Same twelve fields as the JAX ``Scene`` (raytracing_engine_tpu/scene/types.py),
padded to the fixed capacities and masked by 0-dim int32 counts, so one
compiled kernel serves any scene up to capacity. Material i shades object i;
``diffuse`` and ``specular`` are carried for interface parity and never read
(reference shaders/utilities.glsl:8-14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.config import MAX_LIGHTS, MAX_MATERIALS, MAX_OBJECTS
from raytracing_engine_tpu_torch.device import resolve


@dataclasses.dataclass
class Scene:
    # objects
    obj_pos: torch.Tensor      # (MAX_OBJECTS, 3) f32
    obj_radius: torch.Tensor   # (MAX_OBJECTS,)   f32
    obj_count: torch.Tensor    # () int32
    # materials (index-paired with objects)
    mat_color: torch.Tensor    # (MAX_MATERIALS, 3) f32
    mat_diffuse: torch.Tensor  # (MAX_MATERIALS,) f32  [unused — parity]
    mat_specular: torch.Tensor # (MAX_MATERIALS,) f32  [unused — parity]
    mat_shine: torch.Tensor    # (MAX_MATERIALS,) f32
    mat_ambient: torch.Tensor  # (MAX_MATERIALS,) f32
    mat_count: torch.Tensor    # () int32
    # point lights
    light_pos: torch.Tensor    # (MAX_LIGHTS, 3) f32
    light_color: torch.Tensor  # (MAX_LIGHTS, 3) f32
    light_count: torch.Tensor  # () int32

    @property
    def device(self) -> torch.device:
        return self.obj_pos.device

    def to(self, device) -> "Scene":
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def scene_from_numpy(fields, device=None) -> Scene:
    """Scene from arrays by field name — e.g. the JAX Scene's fields through
    ``np.asarray`` — so both packages render the same data. device=None is
    the CUDA card (see device.resolve)."""
    device = resolve(device)
    names = [f.name for f in dataclasses.fields(Scene)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"scene fields missing: {sorted(missing)}")
    out = {}
    for name in names:
        a = np.array(fields[name])  # a writable copy
        dtype = torch.int32 if name.endswith("_count") else torch.float32
        out[name] = torch.as_tensor(a, dtype=dtype).to(device).contiguous()
    return Scene(**out)


def make_scene(objects, materials, lights, device=None) -> Scene:
    """Build a padded Scene from Python-level lists:
    objects: (pos(3,), radius); materials: dicts of color(3,), diffuse,
    specular, shine, ambient; lights: (pos(3,), color(3,)). device=None is
    the CUDA card."""
    device = resolve(device)
    n_obj, n_mat, n_light = len(objects), len(materials), len(lights)
    if n_obj > MAX_OBJECTS or n_mat > MAX_MATERIALS or n_light > MAX_LIGHTS:
        raise ValueError(
            f"scene exceeds fixed capacities "
            f"({n_obj}/{MAX_OBJECTS} objects, {n_mat}/{MAX_MATERIALS} "
            f"materials, {n_light}/{MAX_LIGHTS} lights)"
        )
    f = {
        "obj_pos": np.zeros((MAX_OBJECTS, 3), np.float32),
        "obj_radius": np.zeros((MAX_OBJECTS,), np.float32),
        "obj_count": n_obj,
        "mat_color": np.zeros((MAX_MATERIALS, 3), np.float32),
        "mat_diffuse": np.zeros((MAX_MATERIALS,), np.float32),
        "mat_specular": np.zeros((MAX_MATERIALS,), np.float32),
        "mat_shine": np.ones((MAX_MATERIALS,), np.float32),
        "mat_ambient": np.zeros((MAX_MATERIALS,), np.float32),
        "mat_count": n_mat,
        "light_pos": np.zeros((MAX_LIGHTS, 3), np.float32),
        "light_color": np.zeros((MAX_LIGHTS, 3), np.float32),
        "light_count": n_light,
    }
    for i, (pos, r) in enumerate(objects):
        f["obj_pos"][i] = pos
        f["obj_radius"][i] = r
    for i, m in enumerate(materials):
        f["mat_color"][i] = m["color"]
        f["mat_diffuse"][i] = m.get("diffuse", 1.0)
        f["mat_specular"][i] = m.get("specular", 1.0)
        f["mat_shine"][i] = m.get("shine", 1.0)
        f["mat_ambient"][i] = m.get("ambient", 0.0)
    for i, (pos, color) in enumerate(lights):
        f["light_pos"][i] = pos
        f["light_color"][i] = color
    return scene_from_numpy(f, device)
