"""Camera state and input integration.

The reference's FPS-style camera (reference src/main.rs:343-415, 721-775):
absolute yaw/pitch, quaternion ``from_rotation_z(-yaw) * from_rotation_x(pitch)``,
movement rotated into the camera frame and accumulated into the world-space
position. Z-up, Y-forward, X-right. Input integration is host work on a few
floats, as in the reference's Rust host loop; renderers move the pose to the
scene's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracing_engine_tpu_torch.ops.quaternion import (
    quat_from_rotation_x,
    quat_from_rotation_z,
    quat_mul,
    quat_rotate,
)

# reference src/main.rs:344-348
MOVEMENT_SPEED = 25.0
ROTATION_SPEED = 1.0
MOUSE_SPEED = 1.0

_HALF_PI = 0.5 * math.pi


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class Camera:
    """position: (..., 3) world-space f32; rotation: (..., 2) [yaw, pitch]
    radians. A batch of poses (e.g. ``orbit_path``) is one Camera."""

    position: torch.Tensor
    rotation: torch.Tensor

    @staticmethod
    def initial() -> "Camera":
        return Camera(position=torch.zeros(3), rotation=torch.zeros(2))

    def quat(self) -> torch.Tensor:
        """Camera quaternion [x,y,z,w] — reference src/main.rs:402-404."""
        return quat_mul(
            quat_from_rotation_z(-self.rotation[..., 0]),
            quat_from_rotation_x(self.rotation[..., 1]),
        )


def integrate_input(cam: Camera, move, rot_keys, cursor_delta, dt,
                    window_width) -> Camera:
    """One frame of input integration — reference src/main.rs:732-775.

    move (3,) [right, forward, up] and rot_keys (2,) [yaw, pitch] are key
    axes in {-1,0,1}; cursor_delta (2,) the raw mouse delta in px; dt seconds.
    mouse:    rotation += cursor_delta / window_width * ROTATION * MOUSE
    arrows:   rotation += rot_keys * dt * ROTATION
    pitch clamped to ±π/2 (src/main.rs:770)
    movement: camera-frame axes scaled by dt * MOVEMENT, rotated into world by
              the post-update quaternion, accumulated.
    """
    move, rot_keys, cursor_delta = _f32(move), _f32(rot_keys), _f32(cursor_delta)
    dt, window_width = _f32(dt), _f32(window_width)
    rotation = cam.rotation + cursor_delta / window_width * ROTATION_SPEED * MOUSE_SPEED
    rotation = rotation + rot_keys * (dt * ROTATION_SPEED)
    rotation = torch.stack([rotation[0], rotation[1].clamp(-_HALF_PI, _HALF_PI)])

    q = Camera(position=cam.position, rotation=rotation).quat()
    # world-space basis of the camera frame — reference src/main.rs:406-414
    right = quat_rotate(q, _f32([1.0, 0.0, 0.0]))
    forward = quat_rotate(q, _f32([0.0, 1.0, 0.0]))
    up = quat_rotate(q, _f32([0.0, 0.0, 1.0]))
    delta = move * (dt * MOVEMENT_SPEED)
    world_delta = delta[0] * right + delta[1] * forward + delta[2] * up
    return Camera(position=cam.position + world_delta, rotation=rotation)


def orbit_path(num_frames: int, radius: float = 20.0, height: float = 2.0,
               target=(2.0, 3.0, 1.0)):
    """A scripted orbit aimed at `target` → (positions (F, 3), rotations
    (F, 2) [yaw, pitch]) float32 tensors; ``Camera(*orbit_path(F)).quat()``
    gives the (F, 4) quaternions."""
    t = np.linspace(0.0, 2.0 * np.pi, num_frames, endpoint=False)
    tx, ty, tz = target
    px = tx + radius * np.sin(t)
    py = ty - radius * np.cos(t)
    pz = np.full_like(t, height)
    positions = np.stack([px, py, pz], axis=-1).astype(np.float32)
    # the camera maps forward (0,1,0) to (sin(yaw)cos(pitch),
    # cos(yaw)cos(pitch), sin(pitch)); aim it at the target
    yaw = np.arctan2(tx - px, ty - py)
    pitch = np.arctan2(tz - pz, np.hypot(tx - px, ty - py))
    rotations = np.stack([yaw, pitch], axis=-1).astype(np.float32)
    return torch.from_numpy(positions), torch.from_numpy(rotations)
