"""raytracing_engine_tpu_torch — the cone-march renderer in PyTorch and CUDA.

A port of ``raytracing_engine_tpu`` (JAX/Pallas) that imports torch and
numpy and never JAX. The JAX package stays the reference; this package
mirrors its module names:

    config.py      RenderConfig (pyramid geometry), capacities, constants
    scene/         Scene tensors + the reference default scene
    camera.py      yaw/pitch camera, input integration, orbit path
    ops/           plain tensor math: quaternion, sdf, raygen, march, shade
    ops/cuda/      wrappers of the hand-written CUDA kernels in csrc/
    models/        renderers: conemarch (plain), cuda_renderer (kernels)
    runtime/       frame loop, sequence serving
    utils/         timing metrics
"""

__version__ = "0.1.0"

from raytracing_engine_tpu_torch.config import RenderConfig  # noqa: F401
from raytracing_engine_tpu_torch.scene import Scene, default_scene  # noqa: F401
from raytracing_engine_tpu_torch.camera import Camera  # noqa: F401
