"""Counter-based PCG4D hash RNG (raytracing_engine_tpu/ops/rng_pcg.py).

value = hash(pixel_x, pixel_y, draw_counter, seed): keyed on GLOBAL pixel
coordinates, so any band or tile of the image draws the same numbers, and
the CUDA kernel (csrc/pt.cuh) computes them in-thread bit for bit.

PyTorch has no usable uint32 arithmetic (add and ``>>`` raise on uint32, and
int32 ``>>`` is arithmetic), so the hash runs in int64 holding values in
[0, 2^32) and masks after every step. A 32x32-bit product is split into
16-bit halves so that no int64 product overflows.

Seeds: ``seed_from_key_data`` is the numpy counterpart of the JAX package's
``ops/pallas/rng.key_to_seed``, and ``seed_from_int(s)`` equals
``key_to_seed(jax.random.PRNGKey(s))`` for the default threefry key, whose
data is ``[s >> 32, s & 0xFFFFFFFF]``. Pass ``g`` of a render uses
``pass_seed(base, g) = base + g * -1640531527`` in wrapping int32 arithmetic
(ops/pallas/pt_kernel.py:37,297; pathtracer/wavefront.py:2192).

``r2_planes`` is the quasirandom R_d sampler's draw (ops/rng_pcg.py:80-119):
a per-pixel rotation hashed from the pixel coordinates plus the global pass
index times the dimension's uint32 alpha, wrapping.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223
_KEY_MUL = 2654435761
PASS_PRIME = -1640531527  # int32


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors/ints holding uint32 values."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(x, y, z, w):
    """PCG4D hash of four uint32-valued int64 tensors -> four such tensors."""
    x = (x * _M + _A) & MASK
    y = (y * _M + _A) & MASK
    z = (z * _M + _A) & MASK
    w = (w * _M + _A) & MASK
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    return x, y, z, w


def _to_unit(u):
    """uint32 -> float32 in [0, 1): the top 24 bits times 2^-24 (exact)."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def u32(v) -> int:
    """An int (e.g. an int32 seed) as its uint32 bit pattern."""
    return int(v) & MASK


def to_int32(v) -> int:
    """The low 32 bits of an int as a two's-complement int32."""
    v = int(v) & MASK
    return v - (1 << 32) if v >= 1 << 31 else v


# additive-recurrence (quasirandom "R_d") alphas, Roberts 2018, as exact
# uint32 fractions, so that i * alpha mod 1 wraps exactly in uint32
_R2_ALPHAS = {
    1: (0.6180339887498949,),
    2: (0.7548776662466927, 0.5698402909980532),
    3: (0.8191725133961645, 0.6710436067037893, 0.5497004779019703),
    4: (0.8566748838545029, 0.7338918566271259,
        0.6287067210378087, 0.5385972572236101),
}
_R2_U32 = {n: tuple(np.uint32(int(round(a * 2.0**32)) & MASK) for a in al)
           for n, al in _R2_ALPHAS.items()}
R2_CAMERA = 0x52AD1A7E  # the camera dimensions' rotation channel
R2_NEE = 0x1D0C0FFE     # bounce 0's NEE dimensions' channel


def r2_planes(seed, gpass, n: int, px, py, channel=R2_CAMERA):
    """n low-discrepancy float32 planes in [0, 1) for GLOBAL pass gpass:
    _to_unit(rot_k + gpass * alpha_k) with rot = pcg4d(px, py, channel,
    seed), keyed on the integer coordinate planes px, py (any shape), so a
    band, a tile or a chunk of passes draws the same numbers."""
    if n not in _R2_U32:
        raise ValueError(f"r2_planes supports 1-4 dims, got {n}")
    px = px.to(torch.int64) & MASK
    py = py.to(torch.int64) & MASK
    i = u32(gpass)
    rots = pcg4d(px, py, torch.full_like(px, u32(channel)), torch.full_like(px, u32(seed)))
    return tuple(_to_unit((rots[k] + (i * int(_R2_U32[n][k]) & MASK)) & MASK) for k in range(n))


def uniform_pcg_coords(seed, ctr, n: int, px, py):
    """n float32 planes in [0, 1) keyed by EXPLICIT integer coordinate
    planes px, py (any shape): draw counter ctr, seed an int32 or uint32."""
    px = px.to(torch.int64) & MASK
    py = py.to(torch.int64) & MASK
    seed, ctr = u32(seed), u32(ctr)
    planes = []
    blocks = -(-n // 4)
    for b in range(blocks):
        zz = torch.full_like(px, (ctr * blocks + b) & MASK)
        ww = torch.full_like(px, seed)
        planes.extend(_to_unit(o) for o in pcg4d(px, py, zz, ww))
    return tuple(planes[:n])


def uniform_pcg(seed, ctr, n: int, h: int, w: int, row0=0, col0=0, device=None):
    """(n, h, w) float32 uniforms in [0, 1) as a tuple of planes, keyed by
    the GLOBAL pixel coordinates of the window at (row0, col0)."""
    px = torch.arange(w, dtype=torch.int64, device=device)[None, :] + col0
    py = torch.arange(h, dtype=torch.int64, device=device)[:, None] + row0
    px, py = torch.broadcast_tensors(px, py)
    return uniform_pcg_coords(seed, ctr, n, px, py)


def seed_from_key_data(data) -> int:
    """int32 seed of a PRNG key's uint32 data: the xor of data[i] *
    2654435761 (mod 2^32) — ops/pallas/rng.py key_to_seed."""
    s = 0
    for d in np.asarray(data).astype(np.uint64).ravel():
        s ^= (int(d) * _KEY_MUL) & MASK
    return to_int32(s)


def prng_key_data(s: int) -> np.ndarray:
    """The uint32 data of jax.random.PRNGKey(s) (default threefry key) for
    0 <= s < 2^32: [s >> 32, s & 0xFFFFFFFF]."""
    if not 0 <= int(s) < 1 << 32:
        raise ValueError(f"seed {s} outside [0, 2^32)")
    return np.array([int(s) >> 32, int(s) & MASK], np.uint32)


def seed_from_int(s: int) -> int:
    """key_to_seed(jax.random.PRNGKey(s)); e.g. 1 -> -1640531535."""
    return seed_from_key_data(prng_key_data(s))


def pass_seed(base: int, gpass: int) -> int:
    """int32 seed of global pass gpass: base + gpass * -1640531527, wrapping."""
    return to_int32(int(base) + int(gpass) * PASS_PRIME)
