"""Host runtime: frame loop, live HTTP serving, sequence serving, progressive
checkpoints, replay."""

from raytracing_engine_tpu_torch.runtime.frame import FrameLoop, InputEvent  # noqa: F401
from raytracing_engine_tpu_torch.runtime.live import LiveFrameServer  # noqa: F401
from raytracing_engine_tpu_torch.runtime.serve import render_sequence  # noqa: F401
from raytracing_engine_tpu_torch.runtime.checkpoint import (  # noqa: F401
    ProgressiveState,
    load_checkpoint,
    progressive_render,
    save_checkpoint,
)
from raytracing_engine_tpu_torch.runtime.replay import (  # noqa: F401
    Recorder,
    load_replay,
    save_replay,
)
