"""Host utilities: image output, timing metrics."""

from raytracing_engine_tpu_torch.utils.image import (  # noqa: F401
    bloom, tonemap, to_srgb_u8, write_png)
from raytracing_engine_tpu_torch.utils.timing import FrameStats, conemarch_ray_count  # noqa: F401
