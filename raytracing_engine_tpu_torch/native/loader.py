"""Build-on-first-use loader of the native BVH builder
(raytracing_engine_tpu/native/loader.py, the same rule).

``bvh_builder.cpp`` is compiled with ``g++`` into
``raytracing_engine_tpu_torch/build/libbvh_builder.so`` (gitignored), keyed
on a hash of the source and the flags, and loaded with ctypes. Without a
toolchain ``get_bvh_lib()`` returns None and ``accel.bvh.build_bvh`` takes
its numpy builder: this is host code, not a device kernel, so the fallback
changes only the build time, never the arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import numpy.ctypeslib as npc

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB: dict = {}


def library_path() -> Path:
    return BUILD_DIR / "libbvh_builder.so"


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def _compile(digest: str) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libbvh_builder.{os.getpid()}.so"
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, library_path())  # atomic: a concurrent loader sees old or new
    (BUILD_DIR / "libbvh_builder.sha256").write_text(digest)
    return True


def get_bvh_lib():
    """The builder library with its argtypes set, or None without g++."""
    if "lib" in _LIB:
        return _LIB["lib"]
    digest = _digest()
    stamp = BUILD_DIR / "libbvh_builder.sha256"
    fresh = library_path().exists() and stamp.exists() and stamp.read_text() == digest
    lib = None
    if fresh or _compile(digest):
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            lib = None
    if lib is not None:
        lib.bvh_build.restype = ctypes.c_int64
        lib.bvh_build.argtypes = [
            npc.ndpointer(np.float32, flags="C_CONTIGUOUS"),  # tris (T, 9)
            ctypes.c_int64,                                   # T
            ctypes.c_int,                                     # leaf_size
            ctypes.c_int64,                                   # cap
            npc.ndpointer(np.float32, flags="C_CONTIGUOUS"),  # bb_min
            npc.ndpointer(np.float32, flags="C_CONTIGUOUS"),  # bb_max
            npc.ndpointer(np.int32, flags="C_CONTIGUOUS"),    # first
            npc.ndpointer(np.int32, flags="C_CONTIGUOUS"),    # count
            npc.ndpointer(np.int32, flags="C_CONTIGUOUS"),    # skip
            npc.ndpointer(np.int32, flags="C_CONTIGUOUS"),    # perm
            ctypes.c_int,                                     # method
        ]
    _LIB["lib"] = lib
    return lib


def native_available() -> bool:
    return get_bvh_lib() is not None
