"""The port's host image output (utils/image.py) and golden renderer
(models/golden.py), both numpy copies of the JAX package's modules, against
those modules and the stored artifact tests/golden/golden_64.npz.

Bit for bit throughout: the same numpy code runs on the same float32 and
uint8 inputs. Five tests, so that under pytest-xdist's loadfile scheduling
the file queues behind tests/test_rebin.py, one of the two files that set
the suite's wall time.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_engine_tpu.utils import image as jax_image

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch import utils
from raytracing_engine_tpu_torch.models import golden
from raytracing_engine_tpu_torch.utils import image

GOLDEN = Path(__file__).resolve().parent / "golden" / "golden_64.npz"
TONEMAPS = [dict(mode="none"), dict(mode="reinhard"), dict(mode="aces"),
            dict(mode="reinhard", exposure=2.5, gamma=2.2), dict(mode="aces", exposure=0.5),
            dict(mode="none", gamma=2.2)]


def hdr(seed, shape=(19, 23, 3)):
    """Seeded linear radiance with negatives, values above 1 and a hot spot."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.2, 1.6, shape).astype(np.float32)
    img[3:6, 4:9] = 12.0
    return img


def test_golden_renders_the_stored_artifact(camera_pose):
    """The port's golden pyramid and shading at the fixture pose, on the
    port's default scene, equal golden_64.npz level for level and pixel for
    pixel."""
    z = np.load(GOLDEN)
    pos, quat = camera_pose
    assert np.allclose(z["pos"], pos) and np.allclose(z["quat"], quat)
    cfg = rtt.RenderConfig(width=64, height=64)
    scene = rtt.default_scene(device="cpu")
    levels = golden.render_depth_pyramid(cfg, scene, torch.from_numpy(z["pos"]),
                                         torch.from_numpy(z["quat"]))
    assert len(levels) == cfg.level_count
    for i, level in enumerate(levels):
        assert level.dtype == np.float32 and np.array_equal(level, z[f"level_{i}"]), i
    img = golden.shade(cfg, scene, levels[-1], z["pos"], z["quat"])
    assert img.dtype == np.float32 and np.array_equal(img, z["image"])


def test_image_functions_match_jax():
    """to_srgb_u8, every tonemap mode, bloom and encode_png equal the JAX
    package's on seeded inputs; the package exports what JAX's exports
    from image."""
    assert (utils.bloom, utils.tonemap, utils.to_srgb_u8, utils.write_png) == (
        image.bloom, image.tonemap, image.to_srgb_u8, image.write_png)
    for seed in (0, 1):
        img = hdr(seed)
        for fn in ("to_srgb_u8", "bloom"):
            got, want = getattr(image, fn)(img), getattr(jax_image, fn)(img)
            assert got.dtype == want.dtype and np.array_equal(got, want), fn
        got = image.bloom(img, threshold=0.8, radius=3, strength=1.5)
        assert np.array_equal(got, jax_image.bloom(img, threshold=0.8, radius=3, strength=1.5))
        for kw in TONEMAPS:
            got, want = image.tonemap(img, **kw), jax_image.tonemap(img, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want), kw
        for level in (1, 6):
            assert image.encode_png(img, level) == jax_image.encode_png(img, level)
        u8 = jax_image.to_srgb_u8(img)
        assert image.encode_png(u8) == jax_image.encode_png(u8)
    with pytest.raises(ValueError, match="tonemap mode"):
        image.tonemap(hdr(0), mode="filmic")


def test_png_round_trip(tmp_path):
    """write_png / read_png round trip a float frame and a u8 frame; a CPU
    tensor is written as its numpy array is."""
    img = hdr(2)
    path = tmp_path / "frame.png"
    image.write_png(str(path), img)
    assert np.array_equal(image.read_png(str(path)), image.to_srgb_u8(img))
    u8 = np.random.default_rng(3).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    image.write_png(str(path), u8)
    assert np.array_equal(image.read_png(str(path)), u8)
    assert image.encode_png(torch.from_numpy(img)) == image.encode_png(img)
    assert image.encode_png(torch.from_numpy(u8)) == image.encode_png(u8)


def test_tensors_off_the_cpu_are_refused(tmp_path):
    """A tensor that is not on the CPU (a meta tensor stands in for a CUDA
    frame) is refused with a call to .cpu(), never copied to the host."""
    frame = torch.empty((4, 4, 3), device="meta")
    calls = [lambda: image.to_srgb_u8(frame), lambda: image.tonemap(frame),
             lambda: image.bloom(frame), lambda: image.encode_png(frame),
             lambda: image.write_png(str(tmp_path / "x.png"), frame)]
    for call in calls:
        with pytest.raises(ValueError, match=r"call \.cpu\(\) first"):
            call()
    assert not (tmp_path / "x.png").exists()
