"""The port's path-tracer slice as a whole, on the CPU.

- the plain render_pt_fast against the JAX render_pt_fast at 32x16, 3
  bounces, 2 spp, PRNGKey(13) <-> seed_from_int(13), for material_spheres
  (origin) and cornell_box ((0, 0.2, 0)), held to the megakernel bounds of
  tests/test_megakernel.py:37-40 (< 1% of pixels off by more than 1e-3, mean
  difference < 1e-4, ray counts within max(8, 1e-3 n));
- the K4 wrapper (ops/cuda/pt.render_pt_mega) on CPU tensors is its plain
  version and launches nothing; a band equals the same rows of the full
  render; the furnace corners read 1.0 within 1e-4;
- progressive_render is chunk-invariant within float summation, and a
  checkpoint the JAX package wrote resumes in the port.

The CUDA kernel itself needs the card: chip_smoke.py phases 7-9 hold it to
its plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.pathtracer import scenes as jscenes
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast
from raytracing_engine_tpu.runtime.checkpoint import ProgressiveState as JState
from raytracing_engine_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint

from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import PTConfig, scenes
from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
from raytracing_engine_tpu_torch.runtime import (
    ProgressiveState,
    load_checkpoint,
    progressive_render,
)

torch.set_num_threads(1)

SIZE = dict(width=32, height=16, max_bounces=3)
QUAT = (0.0, 0.0, 0.0, 1.0)
CASES = {"material_spheres": (0.0, 0.0, 0.0), "cornell_box": (0.0, 0.2, 0.0)}
CPU = torch.device("cpu")


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX render_pt_fast of each case: (image, nrays)."""
    cfg = JPTConfig(**SIZE, rng="pcg")
    out = {}
    for name, pos in CASES.items():
        img, n = jax_render_pt_fast(cfg, getattr(jscenes, name)(), jnp.asarray(pos),
                                    jnp.asarray(QUAT), 2, jax.random.PRNGKey(13))
        out[name] = (np.array(img), float(n))
    return out


def _args(name):
    return (PTConfig(**SIZE, rng="pcg"), getattr(scenes, name)(device=CPU),
            torch.tensor(CASES[name]), torch.tensor(QUAT))


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_pt_fast_matches_jax(name, jax_renders):
    cfg, scene, pos, quat = _args(name)
    got, n = render_pt_fast(cfg, scene, pos, quat, 2, seed=seed_from_int(13))
    assert got.shape == (16, 32, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and got.mean() > 0
    want, n_want = jax_renders[name]
    hold_megakernel_bounds(got.numpy(), int(n), want, n_want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mega_wrapper_on_cpu_is_its_plain_version(name, jax_renders):
    cfg, scene, pos, quat = _args(name)
    before = pt.launches
    got, n = pt.render_pt_mega(cfg, scene, pos, quat, 2, seed=seed_from_int(13))
    want, n_want = pt.render_pt_mega_reference(cfg, scene, pos, quat, 2, seed=seed_from_int(13))
    assert pt.launches == before
    assert torch.equal(got, want) and int(n) == int(n_want)
    # the same estimator as the JAX wavefront (sum-then-scale vs divide)
    hold_megakernel_bounds(got.numpy(), int(n), *jax_renders[name])


def test_band_equals_rows_of_full_render():
    cfg, scene, pos, quat = _args("cornell_box")
    full, n_full = pt.render_pt_mega(cfg, scene, pos, quat, 2, seed=7)
    parts = [pt.render_pt_mega(cfg, scene, pos, quat, 2, seed=7, row0=r, band_h=4)
             for r in range(0, 16, 4)]
    assert torch.equal(torch.cat([p[0] for p in parts]), full)
    assert sum(int(p[1]) for p in parts) == int(n_full)
    with pytest.raises(ValueError, match="outside"):
        pt.render_pt_mega(cfg, scene, pos, quat, 1, row0=14, band_h=4)


def test_furnace_corners():
    """tests/test_megakernel.py:43-49 through the wrapper's plain version."""
    cfg = PTConfig(**SIZE, rng="pcg")
    img, _ = pt.render_pt_mega(cfg, scenes.furnace_scene(0.5, 1.0, device=CPU),
                               torch.zeros(3), torch.tensor(QUAT), 32, seed=seed_from_int(13))
    corners = torch.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners.numpy(), 1.0, atol=1e-4)


def test_rejects_unrolled_overflow():
    tris = np.zeros((33, 3, 3), np.float32)
    tris[:, 1, 0] = tris[:, 2, 1] = 1.0
    scene = scenes.build_pt_scene(triangles=tris, tri_mats=np.zeros(33, np.int32),
                                  materials=[{"albedo": (0.5,) * 3}], device=CPU)
    with pytest.raises(ValueError, match="unrolls"):
        pt.render_pt_mega(PTConfig(width=4, height=4), scene, torch.zeros(3),
                          torch.tensor(QUAT), 1)


def _progressive(chunks, cfg, scene, pos, quat, target):
    state = ProgressiveState.start(cfg, pos, quat, key=13, device=CPU)
    for state in progressive_render(cfg, scene, state, target, passes_per_chunk=chunks):
        pass
    return state


@pytest.mark.parametrize("chunk", [1, 3])
def test_progressive_render_chunk_invariant(chunk):
    """Pass i always uses global pass i: chunked sums equal one render's sum
    within float summation (2 * n * 2^-24 of the total, n = 4 passes)."""
    cfg, scene, pos, quat = _args("cornell_box")
    state = _progressive(chunk, cfg, scene, pos, quat, 4)
    assert state.spp_done == 4
    one, _ = pt.render_pt_mega(cfg, scene, pos, quat, 4, seed=seed_from_int(13))
    np.testing.assert_allclose(state.accum.numpy(), (one * 4.0).numpy(),
                               rtol=2 * 4 * 2.0 ** -24, atol=0.0)
    np.testing.assert_allclose(state.image, one.numpy(), rtol=2 * 4 * 2.0 ** -24, atol=0.0)


def test_jax_checkpoint_resumes_in_port(tmp_path, jax_renders):
    """The JAX package writes a 2-spp state (its render, PRNGKey(13)); the
    port loads it, derives the same seed and finishes 4 spp with passes 2-3.
    The result differs from the port's own 4-spp run only by the JAX-vs-port
    difference of passes 0-1: the megakernel bounds hold."""
    img, _ = jax_renders["cornell_box"]
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, JState(accum=jnp.asarray(img) * 2.0, spp_done=2,
                                     key=jax.random.PRNGKey(13),
                                     cam_pos=jnp.asarray(CASES["cornell_box"]),
                                     cam_quat=jnp.asarray(QUAT)))
    cfg, scene, pos, quat = _args("cornell_box")
    state = load_checkpoint(path, device=CPU)
    assert state.spp_done == 2 and state.seed == seed_from_int(13)
    assert torch.equal(state.cam_pos, pos)
    for state in progressive_render(cfg, scene, state, 4, passes_per_chunk=2):
        pass
    assert state.spp_done == 4
    want = _progressive(2, cfg, scene, pos, quat, 4)
    d = np.abs(state.image - want.image).max(-1)
    assert (d > 1e-3).mean() < 0.01 and d.mean() < 1e-4
    # resumed passes 2-3 exactly: the sum minus the loaded part is the
    # port's own 2-spp render at spp_offset 2
    tail, _ = pt.render_pt_mega(cfg, scene, pos, quat, 2, seed=seed_from_int(13), spp_offset=2)
    np.testing.assert_allclose((state.accum - torch.from_numpy(img) * 2.0).numpy(),
                               (tail * 2.0).numpy(), rtol=1e-5, atol=1e-5)
