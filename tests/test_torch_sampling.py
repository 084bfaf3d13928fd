"""The port's sampling features on the CPU against the JAX package, inputs
made from seeds: thin-lens depth of field (PTConfig.aperture), the R_d
sampler (sampler="r2", ops/rng_pcg.r2_planes) and per-tile adaptive spp
(render_pt_mega(adaptive_tol=, adaptive_min=, return_spp=)).

- r2_planes bit for bit JAX's for n = 1-4 on both channels, seeded pixel
  coordinates, seeds and global passes; ops/cuda/common.pick_tile equal to
  JAX's over a grid of sizes and caps;
- render_pt_fast with the thin lens at pcg and at threefry, and with R_d,
  against JAX's render_pt_fast (its jnp route: one compile a case) on
  tests/test_r2_sampler.py's Cornell box, 24x16, 2 bounces, 2 spp, within
  the reference tolerance rtol 1e-3 / atol 2e-3 (XLA contracts sums of
  products into FMAs, the port rounds each product: ROADMAP hazard 1), the
  ray counts equal;
- R_d is chunk invariant: passes 0-3 plus passes 4-7 (spp_offset) equal
  the 8-pass render within rtol 1e-6 / atol 1e-6 (tests/test_r2_sampler.py),
  through render_pt_fast, the plain megakernel and progressive_render;
- the plain K4 (render_pt_mega on CPU tensors) with DOF and R_d bit for bit
  the port's render_pt_fast at 2 spp (1 / 2 is exact, so the megakernel's
  acc * (1 / spp) is render_pt_fast's acc / spp), and, over a ClusterSet,
  the plain K5 bit for bit the plain K4 and a band of it the rows of the
  full render;
- adaptive spp against ONE interpret-mode compile of JAX's
  render_pt_mega(adaptive_tol=0.1, tile=(16, 32)) at 64x32, 2 bounces, a
  16-spp budget, R_d, on a scene whose cells stop at 8, 11 and 16 passes:
  the passes table and nrays equal, the image within the reference
  tolerance; each cell's relative error at its stopping pass and its least
  margin |rel - tol| over its decisions are printed, so that a near tie
  shows. Inside the port: a cell equals the fixed render of its pass count
  bit for bit (the prefix property), a band of whole cells equals those rows
  of the full adaptive render, and adaptive_tol=0 returns the fixed render
  with a table of spp.

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The kernels need the card:
chip_smoke.py phase 23 holds them to these plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.ops import rng_pcg as jrng
from raytracing_engine_tpu.ops.pallas.common import pick_tile as jax_pick_tile
from raytracing_engine_tpu.ops.pallas.pt_kernel import render_pt_mega as jax_render_pt_mega
from raytracing_engine_tpu.pathtracer import scenes as jscenes
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
from raytracing_engine_tpu_torch.ops import rng_pcg
from raytracing_engine_tpu_torch.ops.cuda import common, pt
from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene, scenes
from raytracing_engine_tpu_torch.pathtracer.wavefront import render_pt_fast
from raytracing_engine_tpu_torch.runtime import ProgressiveState, progressive_render

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUAT = (0.0, 0.0, 0.0, 1.0)
BOX_POS = (0.0, 0.2, 0.0)
REF_TOL = dict(rtol=1e-3, atol=2e-3)
CHUNK_TOL = dict(rtol=1e-6, atol=1e-6)
SIZE = dict(width=24, height=16, max_bounces=2)
LENS = dict(aperture=0.3, focus_dist=5.0)
CASES = {"dof_pcg": dict(rng="pcg", **LENS), "dof_threefry": dict(rng="threefry", **LENS),
         "r2": dict(rng="pcg", sampler="r2")}
KEY = 5

# the adaptive case: a dim sky, a diffuse ball, a small bright light and a
# ground; the four 16 x 32 cells stop at 11, 16, 8 and 16 passes
ADAPT = dict(width=64, height=32, max_bounces=2, rng="pcg", sampler="r2")
ADAPT_SPP, ADAPT_TOL, ADAPT_MIN, ADAPT_TILE, ADAPT_KEY = 16, 0.1, 8, (16, 32), 3
ADAPT_SCENE = dict(
    spheres=[((-1.2, 5.0, -0.6), 1.0, 0), ((1.5, 4.0, 1.0), 0.15, 1),
             ((0.0, 5.0, -101.5), 100.0, 2)],
    materials=[{"albedo": (0.8, 0.7, 0.6)}, {"albedo": (0, 0, 0), "emission": (8.0,) * 3},
               {"albedo": (0.6, 0.6, 0.6)}],
    env=(0.02, 0.02, 0.02))


def box_args(**kw):
    return (PTConfig(**SIZE, **kw), scenes.cornell_box(device=CPU), torch.tensor(BOX_POS),
            torch.tensor(QUAT))


def test_r2_planes_and_pick_tile_match_jax():
    rng = np.random.default_rng(17)
    px = rng.integers(0, 4096, (6, 9)).astype(np.int32)
    py = rng.integers(0, 4096, (6, 9)).astype(np.int32)
    for n in range(1, 5):
        for channel in (rng_pcg.R2_CAMERA, rng_pcg.R2_NEE):
            for seed, gpass in ((-1640531535, 0), (int(rng.integers(-2**31, 2**31)), 77777),
                                (-5, 2**31 - 1)):
                want = jrng.r2_planes(seed, gpass, n, jnp.asarray(px), jnp.asarray(py),
                                      channel=channel)
                got = rng_pcg.r2_planes(seed, gpass, n, torch.from_numpy(px),
                                        torch.from_numpy(py), channel=channel)
                assert len(got) == n
                for g, w in zip(got, want):
                    assert g.dtype == torch.float32
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="1-4"):
        rng_pcg.r2_planes(0, 0, 5, torch.zeros(1), torch.zeros(1))
    for h in (1, 5, 8, 16, 24, 32, 64, 100, 256, 1088):
        for w in (1, 7, 128, 200, 256, 509, 640, 1920):
            for cap in ((16, 256), (64, 256), (16, 32), (8, 128), (64, 128)):
                assert common.pick_tile(h, w, *cap) == jax_pick_tile(h, w, *cap), (h, w, cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_pt_fast_matches_jax(case):
    kw = CASES[case]
    want, n_want = jax_render_pt_fast(JPTConfig(**SIZE, **kw), jscenes.cornell_box(),
                                      jnp.asarray(BOX_POS), jnp.asarray(QUAT), 2,
                                      jax.random.PRNGKey(KEY))
    got, n = render_pt_fast(*box_args(**kw), 2, key=KEY)
    assert got.shape == (16, 24, 3) and torch.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)
    assert int(n) == int(n_want)
    if case == "r2":  # JAX's gate: R_d needs the pcg stream
        with pytest.raises(ValueError, match="rng='pcg'"):
            render_pt_fast(*box_args(rng="threefry", sampler="r2"), 1, key=KEY)


def test_r2_chunk_invariance():
    cfg, scene, pos, quat = box_args(rng="pcg", sampler="r2", **LENS)
    whole, n_whole = render_pt_fast(cfg, scene, pos, quat, 8, key=KEY)
    a, na = render_pt_fast(cfg, scene, pos, quat, 4, key=KEY)
    b, nb = render_pt_fast(cfg, scene, pos, quat, 4, key=KEY, spp_offset=4)
    np.testing.assert_allclose(((a + b) / 2).numpy(), whole.numpy(), **CHUNK_TOL)
    assert int(na) + int(nb) == int(n_whole)
    mega, _ = pt.render_pt_mega(cfg, scene, pos, quat, 8, key=KEY)
    ma, _ = pt.render_pt_mega(cfg, scene, pos, quat, 4, key=KEY)
    mb, _ = pt.render_pt_mega(cfg, scene, pos, quat, 4, key=KEY, spp_offset=4)
    np.testing.assert_allclose(((ma + mb) / 2).numpy(), mega.numpy(), **CHUNK_TOL)
    st = ProgressiveState.start(cfg, pos, quat, key=KEY, device=CPU)
    for st in progressive_render(cfg, scene, st, 8, passes_per_chunk=3):
        pass
    assert st.spp_done == 8
    np.testing.assert_allclose(st.image, whole.numpy(), **CHUNK_TOL)


def test_plain_megakernels_equal_render_pt_fast():
    for kw in (dict(rng="pcg", **LENS), dict(rng="pcg", sampler="r2"),
               dict(rng="pcg", sampler="r2", **LENS)):
        cfg, scene, pos, quat = box_args(**kw)
        want, n_want = render_pt_fast(cfg, scene, pos, quat, 2, key=KEY)
        got, n = pt.render_pt_mega(cfg, scene, pos, quat, 2, key=KEY)
        assert torch.equal(got, want) and int(n) == int(n_want), kw
    # over a ClusterSet: tests/test_rebin.py's mesh scene
    tris = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    mats = [{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (8.0,) * 3, "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}]
    tri_mats = np.zeros(len(tris), np.int32)
    scene = build_pt_scene(spheres=[((3.0, 3.0, 3.0), 1.0, 1), ((0.0, 5.0, -52.0), 50.0, 2)],
                           triangles=tris, tri_mats=tri_mats, materials=mats, device=CPU)
    cs = build_clusters(tris, tri_mats=tri_mats, device=CPU)
    cfg = PTConfig(width=32, height=16, max_bounces=2, rng="pcg", sampler="r2", aperture=0.2,
                   focus_dist=5.0)
    pos, quat = torch.tensor([0.0, -0.5, 0.3]), torch.tensor(QUAT)
    mega, n_mega = pt.render_pt_mega(cfg, scene, pos, quat, 2, key=KEY, bvh=cs)
    rebin, n_rebin = pt.render_pt_rebin(cfg, scene, pos, quat, 2, key=KEY, bvh=cs)
    assert torch.equal(rebin, mega) and int(n_rebin) == int(n_mega)
    assert torch.isfinite(mega).all() and mega.mean() > 0
    band, _ = pt.render_pt_mega(cfg, scene, pos, quat, 2, key=KEY, bvh=cs, row0=5, band_h=7)
    assert torch.equal(band, mega[5:12])


def test_adaptive_matches_jax(monkeypatch, capsys):
    jcfg = JPTConfig(**ADAPT)
    want, n_want, spp_want = jax_render_pt_mega(
        jcfg, jax_build_pt_scene(**ADAPT_SCENE), jnp.zeros(3), jnp.asarray(QUAT), ADAPT_SPP,
        jax.random.PRNGKey(ADAPT_KEY), tile=ADAPT_TILE, adaptive_tol=ADAPT_TOL,
        adaptive_min=ADAPT_MIN, return_spp=True)
    cfg = PTConfig(**ADAPT)
    scene = build_pt_scene(**ADAPT_SCENE, device=CPU)
    pos, quat = torch.zeros(3), torch.tensor(QUAT)
    rels = []
    cell_rel = pt.cell_rel

    def record(st, s):
        rels.append((s, cell_rel(st, s)))
        return rels[-1][1]

    monkeypatch.setattr(pt, "cell_rel", record)
    kw = dict(key=ADAPT_KEY, tile=ADAPT_TILE, adaptive_tol=ADAPT_TOL, adaptive_min=ADAPT_MIN,
              return_spp=True)
    got, n, spp_map = pt.render_pt_mega(cfg, scene, pos, quat, ADAPT_SPP, **kw)
    taken = spp_map.numpy()
    with capsys.disabled():
        for (i, j), s_stop in np.ndenumerate(taken):
            at = [float(r[i, j]) for s, r in rels if ADAPT_MIN <= s < ADAPT_SPP and s <= s_stop]
            stop = [float(r[i, j]) for s, r in rels if s == s_stop][0]
            print(f"\n  cell ({i}, {j}): {int(s_stop)} passes, rel {stop:.6f} at the last; least "
                  f"|rel - tol| over its decisions {min(abs(r - ADAPT_TOL) for r in at):.6f}",
                  end="")
    assert spp_map.dtype == torch.float32 and spp_map.shape == (2, 2)
    np.testing.assert_array_equal(taken, np.asarray(spp_want))
    assert int(n) == int(n_want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)
    assert set(taken.ravel().tolist()) == {8.0, 11.0, 16.0}
    # a cell equals the fixed render of its pass count (the prefix property)
    monkeypatch.undo()
    fixed = {s: pt.render_pt_mega(cfg, scene, pos, quat, int(s), key=ADAPT_KEY)[0]
             for s in set(taken.ravel().tolist())}
    for (i, j), s in np.ndenumerate(taken):
        rows, cols = slice(16 * i, 16 * i + 16), slice(32 * j, 32 * j + 32)
        assert torch.equal(got[rows, cols], fixed[s][rows, cols]), (i, j)
    # a band of whole cells equals those rows; tol 0 is the fixed render
    band, n_band, spp_band = pt.render_pt_mega(cfg, scene, pos, quat, ADAPT_SPP, row0=16,
                                               band_h=16, **kw)
    assert torch.equal(band, got[16:]) and torch.equal(spp_band, spp_map[1:])
    flat, n_flat, spp_flat = pt.render_pt_mega(cfg, scene, pos, quat, ADAPT_SPP,
                                               **dict(kw, adaptive_tol=0.0))
    assert torch.equal(flat, fixed[16.0]) and int(n_flat) > int(n)
    assert spp_flat.shape == (2, 2) and (spp_flat == ADAPT_SPP).all()
