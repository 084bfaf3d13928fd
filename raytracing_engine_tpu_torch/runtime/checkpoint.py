"""Checkpoint / resume for progressive accumulation
(raytracing_engine_tpu/runtime/checkpoint.py).

(accumulated radiance, spp done, PRNG key, camera pose) is the complete
state of a progressive render (BASELINE config 4: 1024 spp in chunks). It is
stored as a plain .npz with the JAX package's keys; ``key`` is the uint32
key data (jax.random.PRNGKey(s) is [0, s]): the threefry and pallas streams
fold it in, the pcg stream's base seed is ``seed_from_key_data(key)``, so a
checkpoint the JAX package wrote resumes here and the other way round.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from raytracing_engine_tpu_torch.device import resolve
from raytracing_engine_tpu_torch.ops.rng_pcg import prng_key_data, seed_from_key_data


@dataclasses.dataclass
class ProgressiveState:
    accum: torch.Tensor     # (H, W, 3) SUM of per-pass radiance (not mean)
    spp_done: int
    key: np.ndarray         # uint32 PRNG key data; seed = seed_from_key_data(key)
    cam_pos: torch.Tensor   # (3,)
    cam_quat: torch.Tensor  # (4,)

    @classmethod
    def start(cls, cfg, cam_pos, cam_quat, key=0, device=None) -> "ProgressiveState":
        """A fresh state on `device` (None: the CUDA card): zero radiance,
        0 spp, key = an int seed s (jax.random.PRNGKey(s)) or key data."""
        device = resolve(device)
        key = prng_key_data(key) if np.ndim(key) == 0 else np.asarray(key, np.uint32)
        return cls(
            accum=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device),
            spp_done=0, key=key,
            cam_pos=torch.as_tensor(cam_pos, dtype=torch.float32).to(device),
            cam_quat=torch.as_tensor(cam_quat, dtype=torch.float32).to(device))

    @property
    def seed(self) -> int:
        return seed_from_key_data(self.key)

    @property
    def image(self) -> np.ndarray:
        """Current mean image."""
        return self.accum.cpu().numpy() / max(self.spp_done, 1)


def save_checkpoint(path: str, state: ProgressiveState) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp,
        accum=state.accum.cpu().numpy(),
        spp_done=np.int64(state.spp_done),
        key=np.asarray(state.key, np.uint32),
        cam_pos=state.cam_pos.cpu().numpy(),
        cam_quat=state.cam_quat.cpu().numpy(),
    )
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, device=None) -> ProgressiveState:
    """The state saved at `path`, its tensors on `device` (None: the card)."""
    device = resolve(device)
    z = np.load(path)
    return ProgressiveState(
        accum=torch.from_numpy(z["accum"]).to(device),
        spp_done=int(z["spp_done"]),
        key=np.asarray(z["key"], np.uint32),
        cam_pos=torch.from_numpy(z["cam_pos"]).to(device),
        cam_quat=torch.from_numpy(z["cam_quat"]).to(device),
    )


def progressive_render(cfg, scene, state: ProgressiveState, target_spp: int,
                       passes_per_chunk: int = 16, bvh=None, checkpoint_path: str | None = None,
                       fast: bool = True, donate: bool = True, mesh=None, mega: bool = False,
                       tile=(64, 256), render_fn=None):
    """Advance a progressive render to target_spp in resumable chunks.

    Yields the state after each chunk (also checkpointing if a path is
    given). Pass i of the whole render always uses global pass index i
    (spp_offset = spp_done), so the result does not depend on the chunking
    beyond float summation order.

    The JAX package's signature and route: fast=True renders each chunk
    with pathtracer.wavefront.render_pt_fast(..., key=state.key, bvh=bvh,
    spp_offset=state.spp_done), so the config's rng is kept and bvh may be
    a raw BVH (kernel K8 on the card), a ClusterSet (K6) or an
    InstancedClusters (K7). render_fn replaces render_pt_fast (e.g.
    ops.cuda.pt.render_pt_mega, the K4 megakernel, which renders the pcg
    stream); any function with its signature fits. The scene's and the
    config's features pass through to either (fog and media, the light
    tree, mesh lights: pass g's mesh-light row is keyed on the global pass,
    so the chunks render as one call does). donate and tile change
    memory and tiling in the JAX package, not the result: accepted and
    ignored. fast=False (the stacked integrator) and mesh (sharding, with
    mega) are not ported yet and raise.
    """
    del donate, tile
    if mesh is not None:
        raise NotImplementedError(f"progressive_render(mesh=..., mega={mega}) is not ported yet "
                                  "(ROADMAP.md queue 1 item 6, sharding)")
    if render_fn is None:
        if not fast:
            raise NotImplementedError("progressive_render(fast=False), the stacked integrator "
                                      "render_pt, is not ported yet (ROADMAP.md queue 1 item 5)")
        from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast as render_fn
    while state.spp_done < target_spp:
        n = min(passes_per_chunk, target_spp - state.spp_done)
        img, _ = render_fn(cfg, scene, state.cam_pos, state.cam_quat, n, key=state.key,
                           spp_offset=state.spp_done, bvh=bvh)
        state = ProgressiveState(
            accum=state.accum + img * float(n),
            spp_done=state.spp_done + n,
            key=state.key,
            cam_pos=state.cam_pos,
            cam_quat=state.cam_quat,
        )
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state)
        yield state
