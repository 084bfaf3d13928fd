"""Headless image output: a numpy copy of raytracing_engine_tpu/utils/image.py.

The JAX package's module is numpy only, but importing it pulls in JAX
(through that package's ``__init__``), and this package never imports JAX;
so the port keeps its own copy, with the same functions and signatures.

The reference presents to a swapchain (UNORM formats — linear floats are
clamped to [0,1] and quantized to 8-bit on store, src/main.rs:476-484); the
port is headless and writes PNGs. ``to_srgb_u8`` reproduces the UNORM
clamp+quantize (no gamma — the reference requests *_UNORM, not *_SRGB, so the
shader's linear output is displayed as-is).

An image is a numpy array or a tensor on the CPU, which goes through
``np.asarray`` as the JAX package's callers pass theirs. A tensor on another
device (a CUDA frame) is refused: call ``.cpu()`` first. It is never copied
to the host behind the caller's back.

The PNG encoder is dependency-free (zlib + struct), enough for RGB8 frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _host_array(img) -> np.ndarray:
    """img as a numpy array: a numpy array or a CPU tensor through
    np.asarray; ValueError for a tensor on another device."""
    device = getattr(img, "device", None)
    kind = getattr(device, "type", device)  # a tensor's torch.device, or numpy's "cpu"
    if kind not in (None, "cpu"):
        raise ValueError(f"utils.image takes host images: this one is on {device}; call "
                         ".cpu() first (frames are not copied to the host silently)")
    return np.asarray(img)


def to_srgb_u8(img: np.ndarray) -> np.ndarray:
    """Linear float RGB (H, W, 3) → u8, matching UNORM store semantics:
    clamp to [0,1], round-to-nearest at 8 bits."""
    img = np.asarray(_host_array(img), np.float32)
    return np.clip(np.rint(np.clip(img, 0.0, 1.0) * 255.0), 0, 255).astype(np.uint8)


def tonemap(img: np.ndarray, mode: str = "none", exposure: float = 1.0,
            gamma: float = 1.0) -> np.ndarray:
    """HDR → display mapping for PNG output (the renderers emit linear
    radiance; a bright light clips to white under the UNORM clamp).

    mode: "none" (clamp only — the reference's UNORM semantics),
    "reinhard" (x/(1+x), asymptote 1), or "aces" (Narkowicz's ACES
    filmic fit — the common real-time approximation). exposure scales
    linear radiance first; gamma applies a final 1/gamma encode (set 2.2
    for sRGB-ish displays; default 1.0 preserves the reference's linear
    present)."""
    x = np.asarray(_host_array(img), np.float32) * np.float32(exposure)
    if mode == "reinhard":
        x = x / (1.0 + x)
    elif mode == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        x = np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    elif mode != "none":
        raise ValueError(f"tonemap mode {mode!r}: none | reinhard | aces")
    if gamma != 1.0:
        x = np.clip(x, 0.0, 1.0) ** np.float32(1.0 / gamma)
    return x


def bloom(img: np.ndarray, threshold: float = 1.0, radius: int = 8,
          strength: float = 0.5) -> np.ndarray:
    """HDR bloom: radiance above `threshold` is blurred by a separable
    Gaussian (sigma = radius/2, kernel width 2*radius+1, edge-clamped)
    and added back scaled by `strength`. Apply BEFORE tonemapping — bloom
    models sensor/lens scatter of linear HDR energy; blooming tonemapped
    values just fogs the image."""
    x = np.asarray(_host_array(img), np.float32)
    bright = np.maximum(x - threshold, 0.0)
    sigma = max(radius / 2.0, 1e-3)
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)

    def blur_axis(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        ap = np.pad(a, pad, mode="edge")
        out = np.zeros_like(a)
        for i, w in enumerate(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(i, i + a.shape[axis])
            out += w * ap[tuple(sl)]
        return out

    return x + strength * blur_axis(blur_axis(bright, 0), 1)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode (H, W, 3) u8 or linear-float image as RGB PNG bytes.

    level: zlib effort — 6 for stored artifacts; the live serving path
    uses 1 (encode time beats a few percent of PNG size at 1080p when a
    human is waiting on the frame)."""
    img = _host_array(img)
    if img.dtype != np.uint8:
        img = to_srgb_u8(img)
    h, w, c = img.shape
    assert c == 3, "encode_png expects RGB"

    def chunk(tag: bytes, data: bytes) -> bytes:
        block = tag + data
        return struct.pack(">I", len(data)) + block + struct.pack(
            ">I", zlib.crc32(block) & 0xFFFFFFFF
        )

    # filter type 0 (None) per scanline, inserted in one vectorized copy
    # (the per-row Python join dominated 1080p encodes)
    arr = np.ascontiguousarray(img).reshape(h, w * c)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = arr
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) u8 or linear-float image to an RGB PNG (encoded
    first, so a refused image leaves no file)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal RGB8 PNG reader (filter types 0-4) for round-trip tests."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, ctype = struct.unpack(">IIBB", body[:10])
            assert bit == 8 and ctype == 2, "only RGB8 supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).astype(np.int32)
        cur = np.zeros(stride, np.int32)
        for x in range(stride):
            a = cur[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if ft == 0:
                val = line[x]
            elif ft == 1:
                val = line[x] + a
            elif ft == 2:
                val = line[x] + b
            elif ft == 3:
                val = line[x] + (a + b) // 2
            else:  # Paeth
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                val = line[x] + pred
            cur[x] = val & 0xFF
        out[y] = cur.reshape(w, 3)
        prev = cur
    return out
