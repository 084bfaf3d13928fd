"""The threefry2x32 stream of ``jax.random`` (raytracing_engine_tpu/ops/
pallas/rng.py and the ``rng="threefry"`` draws of pathtracer/wavefront.py):
host key arithmetic and the plain PyTorch version of kernel K9
(csrc/rng.cu).

JAX's default PRNG, with ``jax_threefry_partitionable`` on (the default
since JAX 0.5): element ``i`` of ``jax.random.uniform(key, shape)`` (flat,
row-major) hashes its counter, the two 32-bit words ``(i >> 32, i &
0xFFFFFFFF)``, with ``threefry2x32(key, hi, lo)``; its bits are the xor of
the two output words, and its float ``bitcast((bits >> 9) | 0x3F800000) -
1.0f``. Each element depends only on the key and its own index, so a band of
rows equals the same rows of the full draw bit for bit.

- ``fold_in(key, data)`` is ``threefry2x32(key, 0, data)`` (JAX prng.py
  ``_threefry_fold_in``);
- JAX's ``uniform_planes(seed, n, h, w)`` off the TPU is
  ``uniform(fold_in(PRNGKey(0), uint32(seed)), (n, h, w))`` (rng.py:59-65),
  here ``uniform(planes_key(seed), ...)``; the TPU's hardware stream exists
  on no other backend;
- the path tracer's threefry draw of bounce ``b`` is
  ``uniform(fold_in(pass_key, b), (n, H, W))``, with ``pass_key =
  fold_in(key, global pass)``; its ``"pallas"`` draw is
  ``uniform_planes(key_to_seed(pass_key) + b, n, H, W)``, int32 wrapping.

A key is two uint32 words: ``jax.random.key_data(key)`` as numpy, a pair, a
tensor, or an int ``s`` for ``jax.random.PRNGKey(s)``. ``threefry2x32``
takes Python ints, numpy uint64 arrays or torch int64 tensors holding values
in [0, 2^32): PyTorch has no uint32 add or logical shift, so every step
masks to 32 bits, as ops/rng_pcg.py does.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracing_engine_tpu_torch.ops.rng_pcg import MASK, prng_key_data, seed_from_key_data

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KEY_PARITY = 0x1BD11BDA
ONE_BITS = 0x3F800000  # 1.0f


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 block of counter words (x0, x1) under
    key (k0, k1): a key injection every 4 rounds, rotations 13 15 26 6, then
    17 29 16 24 (JAX prng.py ``_threefry2x32_lowering``)."""
    k0, k1 = (int(k) & MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ KEY_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """The two uint32 words of a key (see the module docstring)."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    if np.ndim(key) == 0:
        key = prng_key_data(int(key))
    data = np.asarray(key).astype(np.int64).ravel()
    if data.shape != (2,):
        raise ValueError(f"a threefry key has 2 uint32 words, got {data.shape[0]}")
    return int(data[0]) & MASK, int(data[1]) & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    """jax.random.fold_in(key, data) for an integer data (uint32 wrap)."""
    return threefry2x32(key_words(key), 0, int(data) & MASK)


def key_to_seed(key) -> int:
    """The int32 seed of a key (JAX ops/pallas/rng.py key_to_seed)."""
    return seed_from_key_data(np.array(key_words(key), np.uint32))


def pcg_base_seed(seed=None, key=None) -> int:
    """The int32 base seed of a pcg render given seed= or key= (not both):
    key_to_seed(key), else seed, else 0 (the JAX default PRNGKey(0))."""
    if seed is not None and key is not None:
        raise ValueError("pass seed= or key=, not both")
    if key is not None:
        return key_to_seed(key)
    return 0 if seed is None else int(seed)


def planes_key(seed: int) -> tuple[int, int]:
    """The key whose uniform draw is uniform_planes(seed, ...)."""
    return fold_in((0, 0), seed)


def random_bits(key, n: int, h: int, w: int, row0: int = 0, band_h=None, device=None):
    """Rows row0 .. row0 + band_h of jax.random.bits(key, (n, h, w)) as an
    int64 (n, band_h or h, w) tensor of uint32 values."""
    bh = h if band_h is None else band_h
    i64 = torch.int64
    p = torch.arange(n, dtype=i64, device=device)[:, None, None]
    r = torch.arange(row0, row0 + bh, dtype=i64, device=device)[None, :, None]
    c = torch.arange(w, dtype=i64, device=device)[None, None, :]
    ctr = p * (h * w) + r * w + c
    y0, y1 = threefry2x32(key_words(key), ctr >> 32, ctr & MASK)
    return y0 ^ y1


def uniform(key, n: int, h: int, w: int, row0: int = 0, band_h=None, device=None):
    """Rows row0 .. row0 + band_h of jax.random.uniform(key, (n, h, w)):
    float32 in [0, 1), the plain version of kernel K9."""
    bits = random_bits(key, n, h, w, row0, band_h, device)
    f = ((bits >> 9) | ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0

