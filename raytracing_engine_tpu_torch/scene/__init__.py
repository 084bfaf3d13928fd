"""Scene tensors and the reference default scene."""

from raytracing_engine_tpu_torch.scene.types import (  # noqa: F401
    Scene,
    make_scene,
    scene_from_numpy,
)
from raytracing_engine_tpu_torch.scene.default import default_scene  # noqa: F401
