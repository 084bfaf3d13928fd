"""Dependency-free video output, the headless "present" for frame streams:
a copy of raytracing_engine_tpu/utils/video.py over the port's
utils/image.to_srgb_u8 (the JAX package's module is numpy only, but
importing it pulls in JAX).

The reference presents frames to a swapchain (src/main.rs:882-928); the
headless analog writes them to a stream a player can consume. Two formats,
both pure Python/numpy (nothing to install, the same bytes as the JAX
package writes):

- YUV4MPEG2 (.y4m): the standard uncompressed interchange format, a short
  text header + raw planar frames. Plays in mpv/VLC/ffplay and pipes
  straight into any encoder (`ffmpeg -i out.y4m out.mp4`). Written as C444
  (no chroma subsampling) BT.601 full-range, so round-trip error is bounded
  by the 8-bit matrix quantization only.
- APNG (.apng/.png): LOSSLESS animation in one file (zlib-compressed RGB8,
  acTL/fcTL/fdAT chunks per the APNG spec); every browser plays it, and
  unlike .y4m the pixel bytes round-trip exactly. Full-replace frames
  (dispose NONE, blend SOURCE), no inter-frame delta encoding.

A frame is a numpy array or a tensor on the CPU. A tensor on another device
(a CUDA frame) is refused with a ValueError: call ``.cpu()`` first, so a
frame never leaves the card behind the caller's back (utils/image.py).

`VideoWriter` is incremental (frame-by-frame, constant memory) so it can be
used directly as a `FrameLoop.run(sink=...)` sink.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracing_engine_tpu_torch.utils.image import _host_array, to_srgb_u8


def _rgb_to_yuv444(rgb_u8: np.ndarray):
    """BT.601 full-range RGB -> (Y, U, V) uint8 planes."""
    r = rgb_u8[..., 0].astype(np.float32)
    g = rgb_u8[..., 1].astype(np.float32)
    b = rgb_u8[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    clip = lambda p: np.clip(p + 0.5, 0.0, 255.0).astype(np.uint8)
    return clip(y), clip(u), clip(v)


class VideoWriter:
    """Streaming .y4m writer.

    >>> w = VideoWriter("orbit.y4m", fps=30)
    >>> loop.run(events, sink=lambda i, img: w.add(img))
    >>> w.close()

    add() accepts float images in [0,1] (H, W, 3) — they go through the
    same sRGB/UNORM quantization as the PNG sink (utils.image.to_srgb_u8),
    so a .y4m frame and the PNG of the same frame show identical tone.
    Frame size is fixed by the first frame (y4m is constant-size; a resize
    mid-stream raises, matching players' expectations).
    """

    def __init__(self, path: str, fps: int = 30):
        self.path = path
        self.fps = int(fps)
        self._f = None
        self._size = None
        self.frames = 0

    def add(self, img: np.ndarray) -> None:
        rgb = to_srgb_u8(_host_array(img))
        h, w = rgb.shape[:2]
        if self._f is None:
            self._f = open(self.path, "wb")
            self._size = (h, w)
            self._f.write(
                f"YUV4MPEG2 W{w} H{h} F{self.fps}:1 Ip A1:1 C444\n".encode()
            )
        elif self._size != (h, w):
            raise ValueError(
                f"y4m streams are constant-size: started {self._size}, "
                f"got {(h, w)}"
            )
        y, u, v = _rgb_to_yuv444(rgb)
        self._f.write(b"FRAME\n")
        self._f.write(y.tobytes())
        self._f.write(u.tobytes())
        self._f.write(v.tobytes())
        self.frames += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ApngWriter:
    """Lossless animated-PNG writer (same sink protocol as VideoWriter).

    >>> w = ApngWriter("orbit.apng", fps=30)
    >>> loop.run(events, sink=lambda i, img: w.add(img))
    >>> w.close()

    add() accepts float [0,1] (H, W, 3) images (UNORM-quantized like the
    PNG sink) or u8. Frames buffer in memory (compressed) because the
    acTL chunk needs the final frame count; the file is written at
    close(). Constant frame size, like y4m — a mid-stream resize raises.
    """

    def __init__(self, path: str, fps: int = 30):
        self.path = path
        self.fps = int(fps)
        self._size = None
        self._frames: list[bytes] = []  # zlib-compressed filtered scanlines
        self.frames = 0

    def add(self, img: np.ndarray) -> None:
        rgb = _host_array(img)
        if rgb.dtype != np.uint8:
            rgb = to_srgb_u8(rgb)
        h, w = rgb.shape[:2]
        if self._size is None:
            self._size = (h, w)
        elif self._size != (h, w):
            raise ValueError(
                f"APNG streams are constant-size: started {self._size}, "
                f"got {(h, w)}"
            )
        raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
        self._frames.append(zlib.compress(raw, 6))
        self.frames += 1

    def close(self) -> None:
        if self._size is None or not self._frames:
            return
        h, w = self._size

        def chunk(tag: bytes, data: bytes) -> bytes:
            block = tag + data
            return struct.pack(">I", len(data)) + block + struct.pack(
                ">I", zlib.crc32(block) & 0xFFFFFFFF)

        seq = 0

        def fctl() -> bytes:
            nonlocal seq
            body = struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, self.fps,
                               0, 0)  # dispose NONE, blend SOURCE
            seq += 1
            return chunk(b"fcTL", body)

        out = [b"\x89PNG\r\n\x1a\n",
               chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
               chunk(b"acTL", struct.pack(">II", len(self._frames), 0))]
        for i, data in enumerate(self._frames):
            out.append(fctl())
            if i == 0:  # frame 0 is the default image, carried by IDAT
                out.append(chunk(b"IDAT", data))
            else:
                out.append(chunk(b"fdAT", struct.pack(">I", seq) + data))
                seq += 1
        out.append(chunk(b"IEND", b""))
        with open(self.path, "wb") as f:
            f.write(b"".join(out))
        self._frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_apng(path: str):
    """Parse an APNG written by ApngWriter: (frames (N,H,W,3) RGB u8, fps).

    Test/verification reader — only the full-frame filter-0 subset
    ApngWriter emits."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = n_frames = None
    fps = 0
    streams: list[bytes] = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, ctype = struct.unpack(">IIBB", body[:10])
            assert bit == 8 and ctype == 2, "only RGB8 supported"
        elif tag == b"acTL":
            n_frames = struct.unpack(">I", body[:4])[0]
        elif tag == b"fcTL":
            num, den = struct.unpack(">HH", body[20:24])
            fps = den / num if num else 0
        elif tag == b"IDAT":
            streams.append(body)
        elif tag == b"fdAT":
            streams.append(body[4:])  # strip sequence number
        pos += 12 + length
    frames = []
    stride = w * 3
    for comp in streams:
        raw = zlib.decompress(comp)
        img = np.zeros((h, w, 3), np.uint8)
        for y in range(h):
            assert raw[y * (stride + 1)] == 0, "only filter 0 supported"
            img[y] = np.frombuffer(
                raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)], np.uint8
            ).reshape(w, 3)
        frames.append(img)
    assert n_frames == len(frames), "acTL frame count mismatch"
    return np.stack(frames), fps


def read_y4m(path: str):
    """Parse a .y4m written by VideoWriter: (frames (N,H,W,3) RGB u8, fps).

    Test/verification reader (BT.601 inverse); only handles the C444
    subset VideoWriter emits.
    """
    with open(path, "rb") as f:
        header = f.readline().decode()
        parts = header.strip().split(" ")
        assert parts[0] == "YUV4MPEG2", header
        w = h = fps = None
        for p in parts[1:]:
            if p.startswith("W"):
                w = int(p[1:])
            elif p.startswith("H"):
                h = int(p[1:])
            elif p.startswith("F"):
                num, den = p[1:].split(":")
                fps = int(num) / int(den)
            elif p.startswith("C") and p != "C444":
                raise ValueError(f"unsupported chroma mode {p}")
        frames = []
        plane = w * h
        while True:
            mark = f.readline()
            if not mark:
                break
            assert mark.startswith(b"FRAME"), mark
            raw = f.read(3 * plane)
            assert len(raw) == 3 * plane, "truncated frame"
            y = np.frombuffer(raw[:plane], np.uint8).reshape(h, w)
            u = np.frombuffer(raw[plane:2 * plane], np.uint8).reshape(h, w)
            v = np.frombuffer(raw[2 * plane:], np.uint8).reshape(h, w)
            yf = y.astype(np.float32)
            uf = u.astype(np.float32) - 128.0
            vf = v.astype(np.float32) - 128.0
            r = yf + 1.402 * vf
            g = yf - 0.344136 * uf - 0.714136 * vf
            b = yf + 1.772 * uf
            rgb = np.stack([r, g, b], -1)
            frames.append(np.clip(rgb + 0.5, 0, 255).astype(np.uint8))
    return np.stack(frames), fps
