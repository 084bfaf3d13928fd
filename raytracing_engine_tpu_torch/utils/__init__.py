"""Host utilities: image and video output, timing metrics, profiling."""

from raytracing_engine_tpu_torch.utils.image import (  # noqa: F401
    bloom, tonemap, to_srgb_u8, write_png)
from raytracing_engine_tpu_torch.utils.timing import (  # noqa: F401
    FrameStats, Timer, conemarch_ray_count)
from raytracing_engine_tpu_torch.utils.video import (  # noqa: F401
    ApngWriter,
    VideoWriter,
    read_apng,
    read_y4m,
)
