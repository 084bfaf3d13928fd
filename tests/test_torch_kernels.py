"""The port's kernel modules (ops/cuda/) vs the JAX Pallas kernels they replace.

On the CPU each wrapper takes its kernel's plain PyTorch version. The same
numpy inputs (the conftest pose and the stored golden levels as seeds) go
through the wrapper and through the JAX Pallas launcher in interpret mode,
specialised to the default scene's live counts (n_obj=4, n_light=2), at the
smallest shapes that exercise it. Tolerances are the repo's golden ones:
depth rtol 1e-4 / atol 1e-3, image rtol 1e-3 / atol 2e-3.

The CUDA kernels themselves need the card: chip_smoke.py holds each to its
plain version there.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_engine_tpu.ops.pallas.depth import depth_level_pallas, upsample_seed
from raytracing_engine_tpu.ops.pallas.fused import depth_shade_fused as jax_fused
from raytracing_engine_tpu.ops.pallas.shade import shade_pallas

from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.ops.cuda import common, depth, fused, shade
from raytracing_engine_tpu_torch.scene import scene_from_numpy

torch.set_num_threads(1)

DEPTH_TOL = dict(rtol=1e-4, atol=1e-3)
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)
STATIC = dict(interpret=True, n_obj=4)


@pytest.fixture(scope="module")
def port(scene, camera_pose):
    """(cfg, scene, pos, quat) of the port for the conftest scene and pose."""
    fields = {f.name: np.asarray(getattr(scene, f.name)) for f in dataclasses.fields(scene)}
    pos, quat = camera_pose
    return (RenderConfig(width=64, height=64), scene_from_numpy(fields, device="cpu"),
            torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(quat)))


def test_depth_module_matches_pallas(small_cfg, scene, camera_pose, golden_levels, port):
    """K1 at level 1 of the 64x64 pyramid (16x16), seeded from golden level 0."""
    cfg, tscene, tpos, tquat = port
    pos, quat = camera_pose
    prev = golden_levels[0]
    w, h = small_cfg.level_dims[1]
    want = depth_level_pallas(small_cfg, 1, scene, jnp.asarray(pos), jnp.asarray(quat),
                              upsample_seed(jnp.asarray(prev), h, w), **STATIC)
    got = depth.depth_level(cfg, 1, tscene, tpos, tquat, torch.from_numpy(prev))
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEPTH_TOL)


def test_shade_module_matches_pallas(small_cfg, scene, camera_pose, golden_levels, port):
    """K3 at 64x64 from the golden finest depth."""
    cfg, tscene, tpos, tquat = port
    pos, quat = camera_pose
    d = golden_levels[-1]
    want = shade_pallas(small_cfg, scene, jnp.asarray(pos), jnp.asarray(quat),
                        jnp.asarray(d), n_light=2, **STATIC)
    got = shade.shade(cfg, tscene, tpos, tquat, torch.from_numpy(d))
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMAGE_TOL)


def test_fused_module_matches_pallas(small_cfg, scene, camera_pose, golden_levels, port):
    """K2 at 64x64, seeded from golden level 2 (32x32)."""
    cfg, tscene, tpos, tquat = port
    pos, quat = camera_pose
    prev = golden_levels[-2]
    want = jax_fused(small_cfg, scene, jnp.asarray(pos), jnp.asarray(quat),
                     upsample_seed(jnp.asarray(prev), 64, 64), n_light=2, **STATIC)
    got = fused.depth_shade_fused(cfg, tscene, tpos, tquat, torch.from_numpy(prev))
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMAGE_TOL)


def test_plain_fused_equals_depth_plus_shade(golden_levels, port):
    """The fused path's plain version is the plain finest level + plain shade,
    bit for bit (the kernels share their device functions the same way)."""
    cfg, tscene, tpos, tquat = port
    prev = torch.from_numpy(golden_levels[-2])
    d = depth.depth_level_reference(cfg, cfg.level_count - 1, tscene, tpos, tquat, prev)
    want = shade.shade_reference(cfg, tscene, tpos, tquat, d)
    got = fused.fused_reference(cfg, tscene, tpos, tquat, prev)
    assert torch.equal(got, want)


def test_cpu_tensors_launch_no_kernel(golden_levels, port):
    cfg, tscene, tpos, tquat = port
    before = (depth.launches, shade.launches, fused.launches)
    lvl0 = depth.depth_level(cfg, 0, tscene, tpos, tquat)
    pyramid = depth.depth_pyramid(cfg, tscene, tpos, tquat)
    assert len(pyramid) == cfg.level_count and torch.equal(pyramid[0], lvl0)
    tail = depth.march_levels(cfg, 2, 3, tscene, tpos, tquat, pyramid[1])
    assert all(torch.equal(a, b) for a, b in zip(tail, pyramid[2:]))
    shade.shade(cfg, tscene, tpos, tquat, torch.from_numpy(golden_levels[-1]))
    fused.depth_shade_fused(cfg, tscene, tpos, tquat, torch.from_numpy(golden_levels[-2]))
    assert (depth.launches, shade.launches, fused.launches) == before
    np.testing.assert_allclose(lvl0.numpy(), golden_levels[0], **DEPTH_TOL)


def test_non_cuda_device_raises(port):
    """Off the CPU the wrappers launch a kernel or raise — never fall back."""
    cfg, tscene, tpos, tquat = port
    meta = tscene.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        depth.depth_level(cfg, 0, meta, tpos.to("meta"), tquat.to("meta"))
    assert depth.launches == 0


def test_launch_args_mirror_the_cuda_struct():
    """ops/cuda/common.Args lists the fields of conemarch::Args in order,
    the per-level arrays with kMaxLevels entries."""
    src = (common.CSRC_DIR / "conemarch.cuh").read_text()
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"(\w+)(\[kMaxLevels\])?\s*[,;]", body)
    assert [f for f, _ in fields] == [f for f, _ in common.Args._fields_]
    arrays = [f for f, n in fields if n]
    assert arrays == [f for f, t in common.Args._fields_ if hasattr(t, "_length_")]
    assert all(getattr(common.Args, f).size == 4 * common.MAX_LEVELS for f in arrays)
    assert int(re.search(r"kMaxLevels = (\d+);", src).group(1)) == common.MAX_LEVELS


def test_unseedable_prev_raises(port):
    """A previous level too small to seed the next one is refused."""
    cfg, tscene, tpos, tquat = port
    with pytest.raises(ValueError, match="cannot be seeded"):
        depth.depth_level(cfg, 2, tscene, tpos, tquat, torch.zeros(3, 3))


def test_pyramid_plan_owns_every_pixel_once():
    """K1's plan (ops/cuda/depth.pyramid_items), no launch, decoded as
    csrc/conemarch.cu pyramid_kernel decodes a ticket: for the launches the
    renderer makes (levels 0..N-2, 0..N-1, and one level), every pixel of
    every level is owned by exactly one tile, and every pixel of a tile after
    the first level has its parent [y/2, x/2] inside the one tile of the level
    before that the tile waits for, which has a smaller ticket. The tile is
    the kernel's block."""
    src = (common.CSRC_DIR / "conemarch.cu").read_text()
    assert (depth.TILE_W, depth.TILE_H) == tuple(
        int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in ("kTileX", "kTileY"))
    launches = [(size, first, last) for size in ((1920, 1088), (1280, 720), (512, 512), (64, 64))
                for n in [RenderConfig(*size).level_count]
                for first, last in ((0, n - 2), (0, n - 1), (n - 1, n - 1), (n // 2, n // 2))]
    for size, first, last in launches:
        dims = RenderConfig(*size).level_dims
        starts, items = depth.pyramid_items(dims, first, last)
        t = np.arange(items)
        lv = first + np.searchsorted(starts, t, side="right") - 1  # the kernel's level of ticket t
        for k in range(first, last + 1):
            w, h = dims[k]
            by = (t[lv == k] - starts[k - first]) // -(-w // depth.TILE_W)
            assert np.all(by * depth.TILE_H < h), (size, first, last, k)
        for lv in range(first, last + 1):
            w, h = dims[lv]
            gx, gy = -(-w // depth.TILE_W), -(-h // depth.TILE_H)
            ys, xs = np.mgrid[:h, :w]
            bx, by = xs // depth.TILE_W, ys // depth.TILE_H
            owners = np.zeros((h, w), np.int64)
            np.add.at(owners, (ys, xs), 1)
            assert np.all(owners == 1) and starts[lv - first] + gx * gy == (
                starts[lv - first + 1] if lv < last else items)
            if lv == first:
                continue
            pw, ph = dims[lv - 1]
            pgx, pgy = -(-pw // depth.TILE_W), -(-ph // depth.TILE_H)
            pbx, pby = bx >> 1, by >> 1
            assert np.all((pbx < pgx) & (pby < pgy))
            parent_ticket = starts[lv - first - 1] + pby * pgx + pbx
            assert np.all(parent_ticket < starts[lv - first] + by * gx + bx)
            px, py = xs >> 1, ys >> 1
            assert np.all((px < pw) & (py < ph)), (size, lv)
            assert np.all((px // depth.TILE_W == pbx) & (py // depth.TILE_H == pby)), (size, lv)
