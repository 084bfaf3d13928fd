"""raytracing_engine_tpu_torch — the renderers in PyTorch and CUDA.

A port of ``raytracing_engine_tpu`` (JAX/Pallas) that imports torch and
numpy and never JAX. The JAX package stays the reference; this package
mirrors its module names:

    config.py      RenderConfig (pyramid geometry), capacities, constants
    device.py      the constructors' device: the CUDA card unless asked
    scene/         Scene tensors + the reference default scene
    camera.py      yaw/pitch camera, input integration, orbit path
    ops/           plain tensor math: quaternion, sdf, raygen, march, shade,
                   vec3 planes, the PCG4D stream (rng_pcg)
    ops/cuda/      wrappers of the hand-written CUDA kernels in csrc/
                   (K1-K3 cone march, K4/K5 path tracer, K6 cluster sweep)
    accel/         meshes, the host-built BVH, ClusterSets (config 3)
    native/        the C++ BVH builder (g++ at first use, numpy fallback)
    models/        cone-march renderers: conemarch (plain), cuda_renderer
    pathtracer/    the path tracer: PTConfig, scenes, the plain wavefront
                   (the oracle of K4 and K5); AOVs, the denoiser, temporal
                   accumulation
    runtime/       frame loop, sequence serving, progressive checkpoints,
                   input replay
    utils/         image and video output, timing metrics, profiling

Constructors put their tensors on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

__version__ = "0.1.0"

from raytracing_engine_tpu_torch.config import RenderConfig  # noqa: F401
from raytracing_engine_tpu_torch.scene import Scene, default_scene  # noqa: F401
from raytracing_engine_tpu_torch.camera import Camera  # noqa: F401
