"""PyTorch port vs the JAX package: config geometry and the small tensor ops.

The same numpy inputs, drawn from a seed, go through each JAX function and
its counterpart in raytracing_engine_tpu_torch. Tolerance 1e-6: both sides
round each float32 op; only library sin/cos and summation order may differ
in the last bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu import camera as jcam
from raytracing_engine_tpu.config import RenderConfig as JaxRenderConfig
from raytracing_engine_tpu.ops import quaternion as jquat
from raytracing_engine_tpu.ops import raygen as jraygen
from raytracing_engine_tpu.ops import sdf as jsdf

from raytracing_engine_tpu_torch import camera as tcam
from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.ops import quaternion as tquat
from raytracing_engine_tpu_torch.ops import raygen as traygen
from raytracing_engine_tpu_torch.ops import sdf as tsdf

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("size", [(64, 64), (512, 512), (1920, 1088)])
def test_config_level_geometry(size):
    want = JaxRenderConfig(width=size[0], height=size[1])
    got = RenderConfig(width=size[0], height=size[1])
    assert got.level_count == want.level_count
    assert got.level_dims == want.level_dims
    assert got.ratio == want.ratio
    for i in range(got.level_count):
        assert got.level_image_size(i) == want.level_image_size(i)
        assert got.level_threshold(i) == want.level_threshold(i)
    # every level is seedable from the one below (compute.glsl:81)
    for (pw, ph), (w, h) in zip(got.level_dims, got.level_dims[1:]):
        assert (w - 1) // 2 < pw and (h - 1) // 2 < ph


def test_config_rejects_bad_sizes():
    with pytest.raises(ValueError):
        RenderConfig(width=60, height=64)
    with pytest.raises(ValueError):
        RenderConfig(width=64, height=128)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _unit_quats(rng, 16), _unit_quats(rng, 16)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, size=16).astype(np.float32)
    pairs = [
        (tquat.quat_mul(torch.from_numpy(a), torch.from_numpy(b)), jquat.quat_mul(a, b)),
        (tquat.quat_rotate(torch.from_numpy(a), torch.from_numpy(v)), jquat.quat_rotate(a, v)),
        (tquat.quat_from_rotation_x(torch.from_numpy(ang)), jquat.quat_from_rotation_x(ang)),
        (tquat.quat_from_rotation_z(torch.from_numpy(ang)), jquat.quat_from_rotation_z(ang)),
        (tquat.quat_identity(), jquat.quat_identity()),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_sdf_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.normal(scale=5.0, size=(6, 5, 3)).astype(np.float32)
    centers = rng.normal(scale=5.0, size=(8, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 3.0, size=8).astype(np.float32)
    got = tsdf.scene_sdf_all(torch.from_numpy(p), torch.from_numpy(centers),
                             torch.from_numpy(radii))
    want = jsdf.scene_sdf_all(p, centers, radii)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got1 = tsdf.sphere_sdf(torch.from_numpy(p), torch.from_numpy(centers[0]), float(radii[0]))
    want1 = jsdf.sphere_sdf(p, centers[0], radii[0])
    np.testing.assert_allclose(_np(got1), np.asarray(want1), **TOL)


@jax.jit
def _jax_raygen(image_size, ratio, q):
    nc = jraygen.pixel_norm_coords(120, 8, image_size, ratio)
    return nc, jraygen.ray_directions(nc, q)


@pytest.mark.parametrize("level", [0, 4, 8])
def test_raygen_matches_jax(level):
    """A 120x8 band of pixels with the 1920x1088 config's per-level pitch."""
    cfg = RenderConfig(width=1920, height=1088)
    jcfg = JaxRenderConfig(width=1920, height=1088)
    q = _unit_quats(np.random.default_rng(2 + level), 1)[0]
    nc_t = traygen.pixel_norm_coords(120, 8, cfg.level_image_size(level), cfg.ratio)
    d_t = traygen.ray_directions(nc_t, torch.from_numpy(q))
    nc_j, d_j = _jax_raygen(jnp.asarray(jcfg.level_image_size(level), jnp.float32),
                            jnp.asarray(jcfg.ratio, jnp.float32), jnp.asarray(q))
    np.testing.assert_allclose(_np(nc_t), np.asarray(nc_j), **TOL)
    np.testing.assert_allclose(_np(d_t), np.asarray(d_j), **TOL)


@jax.jit
def _jax_integrate(cam, move, rot, cursor, dt):
    cam = jcam.integrate_input(cam, move, rot, cursor, dt, jnp.float32(640.0))
    return cam, cam.quat()


def test_integrate_input_matches_jax():
    rng = np.random.default_rng(3)
    cam_t = tcam.Camera.initial()
    cam_j = jcam.Camera.initial()
    for _ in range(6):
        move = rng.integers(-1, 2, size=3).astype(np.float32)
        rot = rng.integers(-1, 2, size=2).astype(np.float32)
        cursor = rng.normal(scale=40.0, size=2).astype(np.float32)
        dt = np.float32(rng.uniform(0.01, 0.1))
        cam_t = tcam.integrate_input(cam_t, move, rot, cursor, dt, 640.0)
        cam_j, quat_j = _jax_integrate(cam_j, move, rot, cursor, dt)
        np.testing.assert_allclose(_np(cam_t.rotation), np.asarray(cam_j.rotation), **TOL)
        np.testing.assert_allclose(_np(cam_t.position), np.asarray(cam_j.position), **TOL)
        np.testing.assert_allclose(_np(cam_t.quat()), np.asarray(quat_j), **TOL)


def test_pitch_is_clamped():
    cam = tcam.integrate_input(tcam.Camera.initial(), (0, 0, 0), (0, 1), (0, 0), 5.0, 64)
    assert float(cam.rotation[1]) == pytest.approx(np.pi / 2)


def test_orbit_path_matches_jax():
    pos_t, rot_t = tcam.orbit_path(5)
    pos_j, rot_j = jcam.orbit_path(5)
    np.testing.assert_array_equal(_np(pos_t), np.asarray(pos_j))
    np.testing.assert_array_equal(_np(rot_t), np.asarray(rot_j))
    quats = tcam.Camera(pos_t, rot_t).quat()  # batched poses
    want = jax.vmap(lambda p, r: jcam.Camera(position=p, rotation=r).quat())(pos_j, rot_j)
    np.testing.assert_allclose(_np(quats), np.asarray(want), **TOL)
