"""Headless frame loop: scripted input → camera → frame.

The reference's per-frame loop (src/main.rs:721-928): input integration →
push-constant update (position accumulates across frames, rotation is
absolute yaw/pitch) → render → present. Here input integration is host math
on the camera (camera.integrate_input); rendering is enqueued on the scene's
device without waiting, and the loop waits only where a frame is read back
(a sink) or timed (stats). There is no window system: interaction is an
InputEvent stream with the reference's WASD/QE + mouse-look semantics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from raytracing_engine_tpu_torch.camera import Camera, integrate_input
from raytracing_engine_tpu_torch.config import RenderConfig
from raytracing_engine_tpu_torch.models import conemarch, cuda_renderer
from raytracing_engine_tpu_torch.utils.timing import FrameStats, conemarch_ray_count


@dataclasses.dataclass
class InputEvent:
    """One frame's worth of input, mirroring the reference's key/mouse state.

    move:   [right(D-A), forward(W-S), up(Q-E)] each in {-1, 0, 1}
            (src/main.rs:751-768)
    rot:    [yaw(Right-Left), pitch(Down-Up)] each in {-1, 0, 1}
            (src/main.rs:738-749)
    cursor: raw mouse delta in px (src/main.rs:686,732)
    dt:     seconds since last update
    """

    move: tuple = (0.0, 0.0, 0.0)
    rot: tuple = (0.0, 0.0)
    cursor: tuple = (0.0, 0.0)
    dt: float = 1.0 / 60.0
    resize: tuple | None = None  # (width, height) — swapchain-recreate analog
    # window-system events (src/main.rs:682-717):
    quit: bool = False                 # Escape / close-requested (:684-694)
    fullscreen_toggle: bool = False    # F11 borderless toggle (:689-696)
    focus: bool | None = None          # focus gained/lost -> unfreeze/freeze
    #                                    + cursor grab toggle (:711-717)


def _wait(img):
    if img.is_cuda:
        torch.cuda.synchronize(img.device)


class FrameLoop:
    """Drives camera state and rendering over an input-event stream.

    render_fn defaults by the scene's device: the CUDA-kernel renderer for a
    scene on a CUDA device, the plain renderer for a scene on the CPU.
    """

    def __init__(
        self,
        cfg: RenderConfig,
        scene,
        render_fn: Optional[Callable] = None,
        camera: Optional[Camera] = None,
        monitor: tuple = (1920, 1080),
    ):
        self.cfg = cfg
        self.scene = scene
        self.device = scene.device
        self.camera = camera if camera is not None else Camera.initial()
        if render_fn is None:
            render_fn = (cuda_renderer.render if self.device.type == "cuda"
                         else conemarch.render)
        self._render = render_fn
        self._primary, self._secondary = conemarch_ray_count(
            cfg, int(scene.light_count))
        # window-system state (src/main.rs:366-383 Data flags)
        self.quit = False
        self.frozen = False          # focus lost -> skip frames (:726)
        self.cursor_grabbed = True   # grabbed while focused (:711-717)
        self.fullscreen = False
        # borderless-fullscreen resolution (the reference reads the monitor's
        # mode, src/main.rs:689-696; headless callers pass theirs)
        self.monitor = monitor
        self._windowed = (cfg.width, cfg.height)
        self._last = None

    def _set_size(self, w: int, h: int):
        # reference enforces width >= height on resize (src/main.rs:702-706)
        if h > w:
            h = w
        self.cfg = dataclasses.replace(self.cfg, width=w, height=h)
        self._primary, self._secondary = conemarch_ray_count(
            self.cfg, int(self.scene.light_count))

    def _pose(self):
        """The camera pose on the scene's device: (position (3,), quat (4,))."""
        return (self.camera.position.to(self.device, non_blocking=True),
                self.camera.quat().to(self.device, non_blocking=True))

    def _advance(self, event: InputEvent) -> bool:
        """Integrate one input event into loop/camera state without rendering.
        Returns True when this event produces a frame, so `run(chunk=...)`
        can integrate a whole replay ahead and render it in sequences."""
        if event.quit:
            # Escape / close (src/main.rs:684-694): stop rendering
            self.quit = True
            return False
        if event.focus is not None:
            # focus change: freeze when unfocused + cursor grab toggle
            # (src/main.rs:711-717; frozen loop skips at :726)
            self.frozen = not event.focus
            self.cursor_grabbed = event.focus
        # window-state events apply even while frozen — only the render-loop
        # body is skipped (src/main.rs:682-717 vs :726)
        if event.fullscreen_toggle:
            # F11 borderless fullscreen (src/main.rs:689-696): switch to the
            # monitor resolution and back
            self.fullscreen = not self.fullscreen
            if self.fullscreen:
                self._windowed = (self.cfg.width, self.cfg.height)
                self._set_size(*self.monitor)
            else:
                self._set_size(*self._windowed)
        if event.resize is not None:
            # resize = new RenderConfig (the reference rebuilds its swapchain,
            # pipeline and pyramid, src/main.rs:778-870)
            self._set_size(*event.resize)
        if self.frozen:
            return False
        self.camera = integrate_input(self.camera, event.move, event.rot,
                                      event.cursor, event.dt, self.cfg.width)
        return True

    def step(self, event: InputEvent):
        """Integrate one input event and render. Returns the (H, W, 3) image
        on the scene's device, enqueued and not waited for."""
        if not self._advance(event):
            return self._last
        self._last = self._render(self.cfg, self.scene, *self._pose())
        return self._last

    def run(
        self,
        events: Iterable[InputEvent],
        sink: Optional[Callable[[int, np.ndarray], None]] = None,
        stats: bool = False,
        chunk: Optional[int] = None,
    ):
        """Render a sequence of frames. With a sink, each frame is copied to
        the host (the 'present'); otherwise frames stay on the device and only
        the last is waited for. Returns per-frame FrameStats when stats=True,
        else the last frame.

        chunk=K: replay-style serving — events are integrated ahead of time
        and frames render K at a time through runtime.serve.render_sequence,
        grouped at resize/fullscreen boundaries. Same images as the per-frame
        path; per-frame stats report the chunk time over its frames."""
        if chunk:
            return self._run_chunked(events, sink, stats, chunk)
        frame_stats = []
        img = None
        for i, ev in enumerate(events):
            t0 = time.perf_counter()
            img = self.step(ev)
            if self.quit:
                break
            if img is None:  # frozen before the first frame: nothing rendered
                continue
            if sink is not None or stats:
                _wait(img)
            dt = time.perf_counter() - t0
            if sink is not None:
                sink(i, img.cpu().numpy())
            if stats:
                frame_stats.append(FrameStats(self._primary, self._secondary, dt))
        if img is not None:
            _wait(img)
        return frame_stats if stats else img

    def _run_chunked(self, events, sink, stats, chunk):
        from raytracing_engine_tpu_torch.runtime import serve

        # phase 1: host-side event integration -> pose sequence, grouped by
        # RenderConfig (resize/fullscreen starts a new group)
        groups = []  # [(cfg, [(event_idx, pos, quat), ...])]
        for i, ev in enumerate(events):
            rendered = self._advance(ev)
            if self.quit:
                break
            if not rendered:
                continue
            if not groups or groups[-1][0] != self.cfg:
                groups.append((self.cfg, []))
            groups[-1][1].append((i, self.camera.position, self.camera.quat()))

        # phase 2: K frames per sequence, one read-back per chunk
        frame_stats = []
        last = None
        for cfg, poses in groups:
            primary, secondary = conemarch_ray_count(cfg, int(self.scene.light_count))
            for k0 in range(0, len(poses), chunk):
                sub = poses[k0:k0 + chunk]
                t0 = time.perf_counter()
                frames = serve.render_sequence(
                    cfg, self.scene,
                    torch.stack([p for _, p, _ in sub]),
                    torch.stack([q for _, _, q in sub]),
                    fn=self._render)
                frames = frames.permute(0, 2, 3, 1).cpu().numpy()
                dt = (time.perf_counter() - t0) / len(sub)
                for (idx, _, _), img in zip(sub, frames):
                    if sink is not None:
                        sink(idx, img)
                    if stats:
                        frame_stats.append(FrameStats(primary, secondary, dt))
                last = frames[-1]
        return frame_stats if stats else last
