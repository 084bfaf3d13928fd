"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled with ``nvcc`` into ``build/libconemarch.so`` inside
this package at first use, keyed on a hash of the ``csrc/`` sources and the
flags, and loaded with ``ctypes`` through a plain C interface. Nothing is
built or imported for CUDA while a module is imported, so the CPU tests import
every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from raytracing_engine_tpu_torch.models.conemarch import check_seed_source

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY = BUILD_DIR / "libconemarch.so"

# --fmad=false and no fast math: the marches' hit tests flip pixels when one
# rounding changes (see csrc/conemarch.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class Args(ctypes.Structure):
    """Mirror of ``conemarch::Args`` (csrc/conemarch.cuh), field for field."""

    _fields_ = [
        ("cam_pos", ctypes.c_void_p),
        ("cam_quat", ctypes.c_void_p),
        ("obj_pos", ctypes.c_void_p),
        ("obj_radius", ctypes.c_void_p),
        ("obj_count", ctypes.c_void_p),
        ("mat_color", ctypes.c_void_p),
        ("mat_shine", ctypes.c_void_p),
        ("mat_ambient", ctypes.c_void_p),
        ("light_pos", ctypes.c_void_p),
        ("light_color", ctypes.c_void_p),
        ("light_count", ctypes.c_void_p),
        ("src", ctypes.c_void_p),
        ("src_w", ctypes.c_int),
        ("src_h", ctypes.c_int),
        ("out", ctypes.c_void_p),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("img_sx", ctypes.c_float),
        ("img_sy", ctypes.c_float),
        ("ratio_x", ctypes.c_float),
        ("ratio_y", ctypes.c_float),
        ("threshold", ctypes.c_float),
        ("render_dist", ctypes.c_float),
        ("max_march_steps", ctypes.c_int),
        ("max_shadow_steps", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


_ENTRIES = ("conemarch_depth", "conemarch_shade", "conemarch_fused")


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build csrc/")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> dict:
    """Compile csrc/ into build/libconemarch.so unless the stamp matches.
    Returns {"built": bool, "seconds": float, "log": nvcc's output}."""
    digest = source_hash()
    stamp = BUILD_DIR / "libconemarch.sha256"
    log_path = BUILD_DIR / "libconemarch.log"
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        log = log_path.read_text() if log_path.exists() else ""
        return {"built": False, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"libconemarch.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / "conemarch.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader sees old or new
    log_path.write_text(log)
    stamp.write_text(digest)
    return {"built": True, "seconds": seconds, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.conemarch_error_string.argtypes = [ctypes.c_int]
    lib.conemarch_error_string.restype = ctypes.c_char_p
    return lib


def check(t, name: str, shape, dtype, device):
    """Raise unless `t` is a contiguous tensor of `shape`/`dtype` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def scene_args(cfg, scene, cam_pos, cam_quat, level: int) -> Args:
    """Args with the camera, the scene tables and the level's constants set;
    every tensor checked to lie on one CUDA device."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"scene on {device}: the CUDA kernels need a CUDA device")
    f32, i32 = torch.float32, torch.int32
    check(cam_pos, "cam_pos", (3,), f32, device)
    check(cam_quat, "cam_quat", (4,), f32, device)
    for name, shape, dtype in (
        ("obj_pos", (8, 3), f32), ("obj_radius", (8,), f32), ("obj_count", (), i32),
        ("mat_color", (8, 3), f32), ("mat_shine", (8,), f32), ("mat_ambient", (8,), f32),
        ("light_pos", (8, 3), f32), ("light_color", (8, 3), f32), ("light_count", (), i32),
    ):
        check(getattr(scene, name), f"scene.{name}", shape, dtype, device)
    img_sx, img_sy = cfg.level_image_size(level)
    return Args(
        cam_pos=cam_pos.data_ptr(), cam_quat=cam_quat.data_ptr(),
        obj_pos=scene.obj_pos.data_ptr(), obj_radius=scene.obj_radius.data_ptr(),
        obj_count=scene.obj_count.data_ptr(),
        mat_color=scene.mat_color.data_ptr(), mat_shine=scene.mat_shine.data_ptr(),
        mat_ambient=scene.mat_ambient.data_ptr(),
        light_pos=scene.light_pos.data_ptr(), light_color=scene.light_color.data_ptr(),
        light_count=scene.light_count.data_ptr(),
        img_sx=img_sx, img_sy=img_sy, ratio_x=cfg.ratio[0], ratio_y=cfg.ratio[1],
        threshold=cfg.level_threshold(level), render_dist=cfg.render_dist,
        max_march_steps=cfg.max_march_steps, max_shadow_steps=cfg.max_shadow_steps,
        device=device.index if device.index is not None else torch.cuda.current_device(),
    )


def set_seed_source(args: Args, prev, h: int, w: int, device):
    """Point args.src at the previous level `prev` (or nullptr: seed 1)."""
    if prev is None:
        return
    check_seed_source(prev.shape, h, w)
    check(prev, "prev", prev.shape, torch.float32, device)
    args.src, args.src_w, args.src_h = prev.data_ptr(), prev.shape[1], prev.shape[0]


def launch(entry: str, args: Args):
    """Launch `entry` on the current stream of device `args.device`; raise if
    the launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream(args.device).cuda_stream
    code = getattr(lib, entry)(ctypes.byref(args), stream)
    if code != 0:
        msg = lib.conemarch_error_string(code).decode()
        raise RuntimeError(f"{entry}: CUDA error {code}: {msg}")
