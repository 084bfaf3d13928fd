"""Tensor math for the render paths (plain PyTorch) and their CUDA kernels
(``ops/cuda/``): quaternion, sdf, raygen, march and shade for the cone
march; vec3 (component planes) and rng_pcg (the PCG4D stream) for the path
tracer."""

from raytracing_engine_tpu_torch.ops.quaternion import (  # noqa: F401
    quat_identity,
    quat_from_rotation_x,
    quat_from_rotation_z,
    quat_mul,
    quat_rotate,
)
from raytracing_engine_tpu_torch.ops.sdf import sphere_sdf, scene_sdf_all  # noqa: F401
from raytracing_engine_tpu_torch.ops.raygen import (  # noqa: F401
    pixel_norm_coords,
    ray_directions,
)
