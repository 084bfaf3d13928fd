"""The port's cone-march slice as a whole, on the CPU.

- models/conemarch (plain PyTorch) against the stored golden artifact and
  against the JAX jnp renderer, with the scene carried over by
  scene_from_numpy; tolerances are the repo's golden ones (depth rtol 1e-4 /
  atol 1e-3, image rtol 1e-3 / atol 2e-3);
- FrameLoop and render_sequence at 64x64: poses held to the JAX
  integrate_input (1e-6); FrameLoop frames held to the port's plain renderer
  at the JAX poses (image tolerance), render_sequence frames to it at the
  same poses (bit for bit: same device, same ops).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu import camera as jcam
from raytracing_engine_tpu.models import conemarch as jconemarch

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch.camera import Camera, orbit_path
from raytracing_engine_tpu_torch.models import conemarch
from raytracing_engine_tpu_torch.runtime import FrameLoop, InputEvent, render_sequence
from raytracing_engine_tpu_torch.scene import scene_from_numpy

torch.set_num_threads(1)

DEPTH_TOL = dict(rtol=1e-4, atol=1e-3)
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)

EVENTS = [
    InputEvent(move=(0, 1, 0), dt=0.05),
    InputEvent(rot=(1, -1), cursor=(12.0, -5.0), dt=0.1),
    InputEvent(move=(1, 0, -1), dt=0.04),
]


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy({f.name: np.asarray(getattr(scene, f.name))
                             for f in dataclasses.fields(scene)}, device="cpu")


@pytest.fixture(scope="module")
def pose(camera_pose):
    pos, quat = camera_pose
    return torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(quat))


def test_default_scene_matches_jax(scene, port_scene):
    mine = rtt.default_scene("cpu")
    for f in dataclasses.fields(mine):
        np.testing.assert_array_equal(getattr(mine, f.name).numpy(),
                                      np.asarray(getattr(scene, f.name)), err_msg=f.name)
        assert getattr(mine, f.name).dtype == getattr(port_scene, f.name).dtype


def test_depth_pyramid_matches_golden(port_scene, pose, golden_levels):
    cfg = rtt.RenderConfig(width=64, height=64)
    levels = conemarch.render_depth_pyramid(cfg, port_scene, *pose)
    assert len(levels) == len(golden_levels)
    for i, (got, want) in enumerate(zip(levels, golden_levels)):
        assert got.shape == want.shape, f"level {i}"
        np.testing.assert_allclose(got.numpy(), want, **DEPTH_TOL, err_msg=f"level {i}")


def test_render_matches_golden_and_jax(small_cfg, scene, camera_pose, port_scene, pose,
                                       golden_image):
    cfg = rtt.RenderConfig(width=64, height=64)
    img = conemarch.render(cfg, port_scene, *pose).numpy()
    assert img.shape == (64, 64, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, golden_image, **IMAGE_TOL)
    want = jconemarch.render_jit(small_cfg, scene, *map(jnp.asarray, camera_pose))
    np.testing.assert_allclose(img, np.asarray(want), **IMAGE_TOL)


@jax.jit
def _jax_step(cam, move, rot, cursor, dt):
    cam = jcam.integrate_input(cam, move, rot, cursor, dt, jnp.float32(64.0))
    return cam, cam.quat()


def _jax_poses(events):
    cam = jcam.Camera.initial()
    poses = []
    for ev in events:
        cam, quat = _jax_step(cam, *(np.asarray(x, np.float32)
                                     for x in (ev.move, ev.rot, ev.cursor, ev.dt)))
        poses.append((np.array(cam.position), np.array(quat)))
    return poses


@pytest.fixture(scope="module")
def walk():
    """The JAX poses of EVENTS and the port's plain frames at those poses."""
    cfg = rtt.RenderConfig(width=64, height=64)
    scene = rtt.default_scene("cpu")
    poses = _jax_poses(EVENTS)
    frames = [conemarch.render(cfg, scene, torch.from_numpy(p), torch.from_numpy(q)).numpy()
              for p, q in poses]
    return poses, frames


@pytest.mark.parametrize("chunk", [None, 2])
def test_frame_loop_matches_plain_renderer(chunk, walk):
    loop = FrameLoop(rtt.RenderConfig(width=64, height=64), rtt.default_scene("cpu"))
    frames = {}
    loop.run(EVENTS, sink=frames.__setitem__, chunk=chunk)
    assert sorted(frames) == [0, 1, 2]
    want_poses, want_frames = walk
    np.testing.assert_allclose(loop.camera.position.numpy(), want_poses[-1][0],
                               rtol=1e-6, atol=1e-6)
    for i, want in enumerate(want_frames):
        np.testing.assert_allclose(frames[i], want, **IMAGE_TOL, err_msg=f"frame {i}")
        assert np.isfinite(frames[i]).all()


def test_frame_loop_walks_forward():
    """10 x W at dt=0.05 moves the camera 12.5 along +y; with stats it
    reports the cone-march ray count."""
    cfg = rtt.RenderConfig(width=16, height=16)
    loop = FrameLoop(cfg, rtt.default_scene("cpu"))
    stats = loop.run([InputEvent(move=(0, 1, 0), dt=0.05)] * 10, stats=True)
    np.testing.assert_allclose(loop.camera.position.numpy(), [0.0, 12.5, 0.0], atol=1e-5)
    assert len(stats) == 10
    assert stats[0].primary_rays == 8 * 8 + 16 * 16
    assert stats[0].secondary_rays == 16 * 16 * 2


@pytest.fixture(scope="module")
def orbit():
    """Two orbit poses and the port's plain frames there, channel-major."""
    cfg = rtt.RenderConfig(width=64, height=64)
    scene = rtt.default_scene("cpu")
    positions, rotations = orbit_path(2)
    quats = Camera(positions, rotations).quat()
    frames = torch.stack([conemarch.render(cfg, scene, positions[k], quats[k]).permute(2, 0, 1)
                          for k in range(2)])
    return positions, quats, frames


@pytest.mark.parametrize("independent", [True, False])
def test_render_sequence_matches_plain_renderer(independent, orbit):
    positions, quats, want = orbit
    frames = render_sequence(rtt.RenderConfig(width=64, height=64), rtt.default_scene("cpu"),
                             positions, quats, independent=independent)
    assert frames.shape == (2, 3, 64, 64)
    assert torch.equal(frames, want)
