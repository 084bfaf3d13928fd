"""Native (C++) host components, loaded with ctypes: the BVH builder
(a copy of raytracing_engine_tpu/native), compiled with g++ at first use."""

from raytracing_engine_tpu_torch.native.loader import get_bvh_lib, native_available  # noqa: F401
