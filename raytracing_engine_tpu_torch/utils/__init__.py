"""Host utilities: timing metrics."""

from raytracing_engine_tpu_torch.utils.timing import FrameStats, conemarch_ray_count  # noqa: F401
