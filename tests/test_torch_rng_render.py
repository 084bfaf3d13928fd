"""The path tracer at rng="threefry" (the default) and rng="pallas" on the
CPU, against the JAX package.

- render_pt_fast against the JAX render_pt_fast at 32x16, 3 bounces, 2 spp,
  PRNGKey(13): threefry on cornell_box from (0, 0.2, 0), pallas on
  material_spheres from the origin (one JAX compile per rng mode), held to
  the megakernel bounds of tests/test_megakernel.py:37-40 (< 1% of pixels
  off by more than 1e-3, mean difference < 1e-4, ray counts within max(8,
  1e-3 n)), and the ray counts equal. Both draw the same uniforms bit for
  bit (tests/test_torch_rng.py); XLA contracts the jitted sums of products
  into fused multiply-adds and the port rounds each product, so a single
  ray may take another branch (pallas on cornell_box from (0, 0.2, 0), not
  a case here: 6,274 rays against JAX's 6,273), hence the image bounds;
- the furnace of tests/test_pallas_rng.py at rng="pallas";
- a band of trace_pass_soa equal to the same rows of the full pass, bit for
  bit, in both modes;
- progressive_render's JAX route: a raw BVH (accel.build_bvh) renders, at
  the default rng, and matches JAX's progressive_render with the same BVH;
  the threefry stream through progressive_render is independent of the
  chunking within float summation.

Kernel K9 itself needs the card: chip_smoke.py phase 16 holds it to its plain
version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import bvh as jbvh
from raytracing_engine_tpu.accel import icosphere
from raytracing_engine_tpu.pathtracer import scenes as jscenes
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast
from raytracing_engine_tpu.runtime.checkpoint import ProgressiveState as JState
from raytracing_engine_tpu.runtime.checkpoint import progressive_render as jax_progressive_render

from raytracing_engine_tpu_torch.accel import BVH
from raytracing_engine_tpu_torch.ops.cuda import rng as krng
from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene, scenes
from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast, trace_pass_soa
from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZE = dict(width=32, height=16, max_bounces=3)
QUAT = (0.0, 0.0, 0.0, 1.0)
CASES = {"threefry": ("cornell_box", (0.0, 0.2, 0.0)),
         "pallas": ("material_spheres", (0.0, 0.0, 0.0))}


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


@pytest.fixture(scope="module")
def jax_renders():
    out = {}
    for rng, (name, pos) in CASES.items():
        img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng=rng), getattr(jscenes, name)(),
                                    jnp.asarray(pos), jnp.asarray(QUAT), 2,
                                    jax.random.PRNGKey(13))
        out[rng] = (np.array(img), float(n))
    return out


def _args(rng):
    name, pos = CASES[rng]
    return (PTConfig(**SIZE, rng=rng), getattr(scenes, name)(device=CPU), torch.tensor(pos),
            torch.tensor(QUAT))


@pytest.mark.parametrize("rng", sorted(CASES))
def test_render_pt_fast_matches_jax(rng, jax_renders):
    cfg, scene, pos, quat = _args(rng)
    before = krng.launches
    got, n = render_pt_fast(cfg, scene, pos, quat, 2, key=13)
    assert krng.launches == before  # a CPU scene draws through the plain version
    assert got.shape == (16, 32, 3) and torch.isfinite(got).all() and got.mean() > 0
    hold_megakernel_bounds(got.numpy(), int(n), *jax_renders[rng])
    assert int(n) == jax_renders[rng][1]


def test_furnace_with_pallas_rng():
    """tests/test_pallas_rng.py's furnace through the port."""
    cfg = PTConfig(width=48, height=32, max_bounces=3, rng="pallas")
    img, _ = render_pt_fast(cfg, scenes.furnace_scene(albedo=0.5, le=1.0, device=CPU),
                            torch.zeros(3), torch.tensor(QUAT), 64, key=3)
    img = img.numpy()
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners, 1.0, atol=1e-4)
    h, w, _ = img.shape
    patch = img[h // 2 - 2: h // 2 + 2, w // 2 - 2: w // 2 + 2]
    assert abs(patch.mean() - 0.5) < 0.05


def test_band_equals_rows_of_full_pass():
    for rng in sorted(CASES):
        cfg, scene, pos, quat = _args(rng)
        key = np.array([3, 0x80000001], np.uint32)
        full, n_full = trace_pass_soa(cfg, scene, pos, quat, key=key)
        parts = [trace_pass_soa(cfg, scene, pos, quat, key=key, row0=r, band_h=4)
                 for r in range(0, 16, 4)]
        assert torch.equal(torch.cat([p[0] for p in parts]), full), rng
        assert sum(int(p[1]) for p in parts) == int(n_full)


def _bvh_scene():
    """tests/test_torch_bvh_traverse.py's mesh scene: icosphere(2), a sphere
    light, a ground sphere."""
    tris = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    mats = [{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (8.0,) * 3, "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
            {"albedo": (0.3, 0.7, 0.4), "kind": DIFFUSE}]
    spheres = [((3.0, 3.0, 3.0), 1.0, 1), ((0.0, 5.0, -52.0), 50.0, 2)]
    tri_mats = np.where(np.arange(tris.shape[0]) % 2 == 0, 0, 3).astype(np.int32)
    return dict(spheres=spheres, triangles=tris, tri_mats=tri_mats, materials=mats)


def test_progressive_render_with_a_raw_bvh_matches_jax():
    """The JAX route (fast=True: render_pt_fast with the state's key) at the
    default rng: two chunks of one pass each through a raw BVH."""
    kw = _bvh_scene()
    cfg = dict(width=32, height=16, max_bounces=2)
    jb = jbvh.build_bvh(kw["triangles"])
    jstate = JState(accum=jnp.zeros((16, 32, 3)), spp_done=0, key=jax.random.PRNGKey(3),
                    cam_pos=jnp.zeros(3), cam_quat=jnp.asarray(QUAT))
    for jstate in jax_progressive_render(JPTConfig(**cfg), jax_build_pt_scene(**kw), jstate, 2,
                                         passes_per_chunk=1, bvh=jb, donate=False):
        pass
    pb = BVH(**{f: torch.from_numpy(np.array(getattr(jb, f))) for f in
                ("bb_min", "bb_max", "first_tri", "tri_count", "skip", "v0", "e1", "e2", "perm")})
    state = ProgressiveState.start(PTConfig(**cfg), [0.0, 0.0, 0.0], QUAT, key=3, device=CPU)
    for state in progressive_render(PTConfig(**cfg), build_pt_scene(device=CPU, **kw), state, 2,
                                    passes_per_chunk=1, bvh=pb, donate=False, tile=(8, 128)):
        pass
    assert state.spp_done == 2 and (state.image.max(-1) > 0).mean() > 0.05
    d = np.abs(state.image - np.asarray(jstate.accum) / 2.0).max(-1)
    assert (d > 1e-3).mean() < 0.01 and d.mean() < 1e-4
    with pytest.raises(NotImplementedError, match="item 5"):
        next(progressive_render(PTConfig(**cfg), None, state, 4, fast=False))
    with pytest.raises(NotImplementedError, match="item 6"):
        next(progressive_render(PTConfig(**cfg), None, state, 4, mesh=object(), mega=True))


@pytest.mark.parametrize("chunk", [1, 3])
def test_threefry_progressive_render_is_chunk_invariant(chunk):
    """Pass i always folds in global pass i: the chunked sum equals one
    4-spp render's within float summation (2 * n * 2^-24 of the total)."""
    cfg, scene, pos, quat = _args("threefry")
    state = ProgressiveState.start(cfg, pos, quat, key=13, device=CPU)
    for state in progressive_render(cfg, scene, state, 4, passes_per_chunk=chunk):
        pass
    one, _ = render_pt_fast(cfg, scene, pos, quat, 4, key=13)
    assert state.spp_done == 4
    np.testing.assert_allclose(state.accum.numpy(), (one * 4.0).numpy(),
                               rtol=2 * 4 * 2.0 ** -24, atol=0.0)
