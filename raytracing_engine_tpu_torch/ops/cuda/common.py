"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source of ``csrc/`` is compiled with ``nvcc`` into its own
library, ``build/lib<name>.so`` inside this package (``libconemarch.so``:
K1-K3; ``libpt.so``: K4 and K5; ``libpt_lights.so``: their light forms;
``libcluster.so``: K6; ``libbvh.so``: K8; ``libinstanced.so``: K7;
``librng.so``: K9), at first use and all at once (one nvcc process per
source, started together). Each library is keyed on a hash of every
``csrc/`` file and the flags, and loaded with ``ctypes`` through a plain C
interface: an entry takes a pointer to its argument struct and a stream.
Nothing is built or imported for CUDA while a module is imported, so the CPU
tests import every module of the port.
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

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# library name -> (its source in csrc/, its C entries)
LIBRARIES = {
    "conemarch": ("conemarch.cu", ("conemarch_pyramid", "conemarch_shade", "conemarch_fused")),
    "pt": ("pt.cu", ("pt_render", "pt_rebin", "pt_adapt")),
    "pt_lights": ("pt_lights.cu", ("pt_lights_render", "pt_lights_rebin")),
    "cluster": ("cluster.cu", ("cluster_intersect",)),
    "bvh": ("bvh.cu", ("bvh_traverse",)),
    "instanced": ("instanced.cu", ("instanced_intersect",)),
    "rng": ("rng.cu", ("rng_uniform",)),
}

# conemarch::kMaxLevels: the pyramid levels one K1 launch can march
MAX_LEVELS = 16

# --fmad=false and no fast math: the marches' hit tests flip pixels when one
# rounding changes (see csrc/conemarch.cuh), and the path tracer's branch
# decisions likewise (csrc/pt.cuh).
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
        ("first", ctypes.c_int),
        ("last", ctypes.c_int),
        ("items", ctypes.c_int),
        ("epoch", ctypes.c_int),
        ("sync", ctypes.c_void_p),
        ("lvl_item", ctypes.c_int * MAX_LEVELS),
        ("lvl_w", ctypes.c_int * MAX_LEVELS),
        ("lvl_h", ctypes.c_int * MAX_LEVELS),
        ("lvl_off", ctypes.c_int * MAX_LEVELS),
        ("lvl_sx", ctypes.c_float * MAX_LEVELS),
        ("lvl_sy", ctypes.c_float * MAX_LEVELS),
        ("lvl_thr", ctypes.c_float * MAX_LEVELS),
        ("device", ctypes.c_int),
    ]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


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
    """Compile every library of LIBRARIES whose stamp does not match, one
    nvcc process per source, all started together. Returns {"built": names
    built, "seconds": wall time of the build, "log": nvcc's output of every
    library}."""
    digest = source_hash()
    todo = [name for name in LIBRARIES
            if not (library_path(name).exists()
                    and (BUILD_DIR / f"lib{name}.sha256").exists()
                    and (BUILD_DIR / f"lib{name}.sha256").read_text() == digest)]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(exist_ok=True)
        procs = {}
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / LIBRARIES[name][0])]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            (BUILD_DIR / f"lib{name}.log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc {LIBRARIES[name][0]} failed ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, library_path(name))  # atomic: a loader sees old or new
            (BUILD_DIR / f"lib{name}.sha256").write_text(digest)
        if failed:
            raise RuntimeError("\n".join(failed))
    logs = []
    for name in LIBRARIES:
        path = BUILD_DIR / f"lib{name}.log"
        logs.append(f"[lib{name}.so]\n" + (path.read_text() if path.exists() else ""))
    return {"built": todo, "seconds": time.perf_counter() - t0, "log": "\n".join(logs)}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` of LIBRARIES (built first if needed)."""
    build()
    lib = ctypes.CDLL(str(library_path(name)))
    for entry in LIBRARIES[name][1]:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]  # &args, stream
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def pick_tile(h: int, w: int, max_th: int = 16, max_tw: int = 256):
    """Tile dims that divide (h, w), as the JAX package picks them
    (ops/pallas/common.py:11-22: the widest of max_tw, 256, 128 under max_tw
    that divides w, else w; the tallest of max_th, 16, 8 under max_th that
    divides h, else h). The kernels here take no tiles; adaptive spp
    (ops/cuda/pt.py adaptive_grid) reads them as the cells whose pixels stop
    sampling together."""
    tw = next((t for t in (max_tw, 256, 128) if t <= max_tw and w % t == 0), w)
    th = next((t for t in (max_th, 16, 8) if t <= max_th and h % t == 0), h)
    return min(th, h), min(tw, w)


def flat_rays(o_planes, d_planes, t_max):
    """(shape, o, d, t0) of a grid of rays for a sweep kernel: the origin and
    direction planes flattened to contiguous f32 (n,) tensors, and t_max (a
    scalar or a plane) as an (n,) plane; a scalar through torch.full, since
    a host-to-device copy would wait for the stream."""
    shape = tuple(o_planes[0].shape)
    o = tuple(p.reshape(-1).to(torch.float32).contiguous() for p in o_planes)
    d = tuple(p.reshape(-1).to(torch.float32).contiguous() for p in d_planes)
    if isinstance(t_max, torch.Tensor):
        t0 = t_max.to(torch.float32).expand(shape).reshape(-1).contiguous()
    else:
        t0 = torch.full((o[0].numel(),), float(t_max), dtype=torch.float32, device=o[0].device)
    return shape, o, d, t0


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
    from raytracing_engine_tpu_torch.models.conemarch import check_seed_source

    if prev is None:
        return
    check_seed_source(prev.shape, h, w)
    check(prev, "prev", prev.shape, torch.float32, device)
    args.src, args.src_w, args.src_h = prev.data_ptr(), prev.shape[1], prev.shape[0]


def launch(entry: str, args, name: str = "conemarch"):
    """Launch `entry` of library `name` on the current stream of device
    `args.device`; raise if the launch was refused."""
    lib = library(name)
    stream = torch.cuda.current_stream(args.device).cuda_stream
    code = getattr(lib, entry)(ctypes.addressof(args), stream)
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{entry}: CUDA error {code}: {msg}")
