"""K9: threefry2x32 uniforms through the CUDA kernel ``rng_kernel``
(csrc/rng.cu), which replaces raytracing_engine_tpu/ops/pallas/rng.py
``_rng_kernel``.

``uniform_key(key, n, h, w, row0, band_h)`` is rows row0 .. row0 + band_h
of ``jax.random.uniform(key, (n, h, w))``; ``uniform_planes`` keeps the JAX
signature and draws JAX's off-TPU stream (``interpret`` and ``tile`` are TPU
knobs, accepted and ignored). Every draw of the path tracer at
``rng="threefry"`` or ``"pallas"`` comes through ``uniform_key``. On
``device="cpu"`` the plain version (ops/rng.py ``uniform``) runs; on a CUDA
device the kernel launches or raises. The plain version is for the tests
and for the comparison on the card, never the card's path.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_engine_tpu_torch.device import resolve
from raytracing_engine_tpu_torch.ops import rng
from raytracing_engine_tpu_torch.ops.cuda import common

# kernel launches since the count was last set to 0 (plain-version calls do
# not count), and the elements those launches wrote
launches = 0
work = {"elements": 0}


class RngArgs(ctypes.Structure):
    """Mirror of ``rng::Args`` (csrc/rng.cu), field for field."""

    _fields_ = [
        ("out", ctypes.c_void_p),
        ("k0", ctypes.c_uint),
        ("k1", ctypes.c_uint),
        ("n", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("band_h", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


def uniform_key(key, n: int, h: int, w: int, row0: int = 0, band_h=None, device=None):
    """(n, band_h or h, w) float32 uniforms in [0, 1): rows row0 .. row0 +
    band_h of jax.random.uniform(key, (n, h, w)), on `device` (None: the
    CUDA card). key: see ops/rng.py."""
    global launches
    dev = resolve(device)
    bh = h if band_h is None else band_h
    if not (n >= 0 and 0 <= row0 and bh >= 0 and row0 + bh <= h and w >= 0):
        raise ValueError(f"rows {row0}..{row0 + bh} of a ({n}, {h}, {w}) draw")
    if dev.type == "cpu":
        return rng.uniform(key, n, h, w, row0, band_h, dev)
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on a CUDA device, not {dev}")
    if n > 65535:
        raise ValueError(f"{n} planes: the grid's y dimension holds at most 65535")
    k0, k1 = rng.key_words(key)
    out = torch.empty((n, bh, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    args = RngArgs(out=out.data_ptr(), k0=k0, k1=k1, n=n, h=h, w=w, row0=row0, band_h=bh,
                   device=dev.index if dev.index is not None else torch.cuda.current_device())
    common.launch("rng_uniform", args, name="rng")
    launches += 1
    work["elements"] += out.numel()
    return out


def uniform_planes(seed, n: int, h: int, w: int, interpret=None, tile=(16, 256), device=None):
    """(n, h, w) float32 uniforms in [0, 1) from an int32 seed: JAX's
    uniform_planes as drawn off the TPU,
    jax.random.uniform(fold_in(PRNGKey(0), uint32(seed)), (n, h, w))."""
    del interpret, tile
    return uniform_key(rng.planes_key(int(seed)), n, h, w, device=device)
