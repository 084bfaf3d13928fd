"""Host runtime: frame loop and sequence serving."""

from raytracing_engine_tpu_torch.runtime.frame import FrameLoop, InputEvent  # noqa: F401
from raytracing_engine_tpu_torch.runtime.serve import render_sequence  # noqa: F401
