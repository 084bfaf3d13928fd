"""The port's post-process path (pathtracer/aov.py, denoise.py,
temporal.py) and its profiling hooks (utils/profiling.py, utils/timing
Timer) against the JAX package on the CPU, inputs made from numpy seeds.

- render_aovs: spheres at 32x24, 2 spp, AO on; an icosphere mesh through a
  raw BVH (JAX's gather traversal, which compiles no interpret-mode kernel),
  with the port's ClusterSet route held to its BVH route. Hit masks equal
  but for at most 1e-3 of the pixels, the planes within atol / rtol 1e-5
  elsewhere. A pixel counts against that share (rounded up to a whole
  pixel) when its hit flag differs or a plane leaves the tolerance. XLA
  contracts jitted sums of products into fused multiply-adds and the port
  rounds each product, which is rounding, but where a ray grazes a sphere
  the root's cancellation (b * b - c) amplifies it: at 32x24 one pixel on
  the silhouette of the emissive ball takes a normal 2.7e-5 off JAX's.
- denoise at 40x24, 3 iterations, with sky, emissive and firefly pixels,
  with its own noise estimate and with a noise= override holding zeros and
  positives: atol / rtol 2e-5.
- temporal_step over a static, a moved and a teleported pose, fed JAX's AOV
  planes and seeded radiance, and temporal_noise: atol / rtol 1e-5 but on
  pixels whose validity flips (at most 1e-3 of them, counted: 0 at this
  seed).

Seven tests, so that under pytest-xdist's loadfile scheduling the file
queues behind tests/test_rebin.py. The card's side (kernels K6, K7, K8 and
K9 under render_aovs) is held to these CPU paths by chip_smoke.py phase 18.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import bvh as jbvh
from raytracing_engine_tpu.ops.quaternion import quat_from_rotation_z as jax_quat_z
from raytracing_engine_tpu.pathtracer import aov as jax_aov
from raytracing_engine_tpu.pathtracer.denoise import denoise as jax_denoise
from raytracing_engine_tpu.pathtracer import temporal as jax_temporal
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.utils import profiling as jax_profiling
from raytracing_engine_tpu.utils import timing as jax_timing

import raytracing_engine_tpu_torch as rtt
from raytracing_engine_tpu_torch import pathtracer, utils
from raytracing_engine_tpu_torch.accel import BVH, build_clusters, icosphere
from raytracing_engine_tpu_torch.pathtracer import (
    DIFFUSE,
    PTConfig,
    build_pt_scene,
    denoise,
    render_aovs,
    temporal_init,
    temporal_noise,
    temporal_step,
)
from raytracing_engine_tpu_torch.pathtracer import temporal
from raytracing_engine_tpu_torch.utils import profiling
from raytracing_engine_tpu_torch.utils.timing import Timer

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUAT = (0.0, 0.0, 0.0, 1.0)
POS = (0.0, 0.0, 0.0)
KEY = 9  # jax.random.PRNGKey(9)
AOV_SIZE = dict(width=32, height=24)
AOV_TOL = dict(atol=1e-5, rtol=1e-5)
FLIP_SHARE = 1e-3
DENOISE_TOL = dict(atol=2e-5, rtol=2e-5)


def sphere_kw():
    """A ball on a floor, a second ball and an emissive one (albedo 0)."""
    mats = [{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE},
            {"albedo": (0.2, 0.5, 0.8), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (6.0,) * 3, "kind": DIFFUSE}]
    return dict(spheres=[((0.0, 8.0, -101.0), 100.0, 0), ((0.0, 8.0, 0.0), 1.0, 1),
                         ((2.2, 9.0, 0.6), 0.7, 2)], materials=mats)


def mesh_kw():
    """icosphere(2) at (0, 6, 0) with two materials, on a floor sphere."""
    tris = icosphere(subdivisions=2, radius=1.0, center=(0.0, 6.0, 0.0))
    mats = [{"albedo": (0.9, 0.1, 0.1), "kind": DIFFUSE},
            {"albedo": (0.1, 0.6, 0.3), "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE}]
    tri_mats = (np.arange(tris.shape[0]) % 2).astype(np.int32)
    return dict(spheres=[((0.0, 6.0, -51.0), 50.0, 2)], triangles=tris, tri_mats=tri_mats,
                materials=mats)


def jax_aovs(kw, spp, ao_radius, bvh=None, size=AOV_SIZE, pos=POS, quat=QUAT, key=KEY):
    out = jax_aov.render_aovs(JPTConfig(**size), jax_build_pt_scene(**kw), jnp.asarray(pos),
                              jnp.asarray(quat, jnp.float32), spp, jax.random.PRNGKey(key),
                              bvh=bvh, ao_radius=ao_radius)
    return {k: np.array(v) for k, v in out.items()}


def allowed(n: int) -> int:
    """1e-3 of n pixels, rounded up to a whole pixel."""
    return math.ceil(FLIP_SHARE * n)


def flipped(got: dict, want: dict, tol) -> np.ndarray:
    """Pixels whose hit flag differs or where a plane leaves tol."""
    got = {k: np.asarray(v) for k, v in got.items()}
    bad = (got["depth"] > 0) != (want["depth"] > 0)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        off = ~np.isclose(g, w, **tol)
        bad |= off.any(-1) if off.ndim == 3 else off
    return bad


def hold_aovs(got: dict, want: dict):
    assert set(got) == set(want)
    bad = flipped(got, want, AOV_TOL)
    assert bad.sum() <= allowed(bad.size), f"pixels {np.argwhere(bad).tolist()} differ"
    hit = want["depth"] > 0
    assert hit.mean() > 0.3 and (~hit).any()  # both hits and sky in view


def test_render_aovs_spheres_match_jax():
    """Spheres, 2 spp, AO on (radius 2): the port's planes equal JAX's."""
    want = jax_aovs(sphere_kw(), 2, 2.0)
    got = render_aovs(PTConfig(**AOV_SIZE), build_pt_scene(device=CPU, **sphere_kw()),
                      torch.tensor(POS), torch.tensor(QUAT), 2, KEY, ao_radius=2.0)
    assert all(v.device == CPU for v in got.values())
    hold_aovs(got, want)
    assert (want["ao"] < 1.0).any() and (want["ao"][want["depth"] == 0] == 1.0).all()
    # the emissive ball reads albedo 0: the denoiser's demodulation skips it
    no_ao = render_aovs(PTConfig(**AOV_SIZE), build_pt_scene(device=CPU, **sphere_kw()),
                        POS, QUAT, 2, KEY)
    assert "ao" not in no_ao and torch.equal(no_ao["depth"], got["depth"])


def test_render_aovs_mesh_matches_jax():
    """An icosphere mesh, 2 spp, AO on (radius 1): the port's raw-BVH route
    against JAX's raw-BVH gather route, the port's ClusterSet route (the
    plain version of kernel K6) against its BVH route."""
    kw = mesh_kw()
    jb = jbvh.build_bvh(kw["triangles"])
    want = jax_aovs(kw, 2, 1.0, bvh=jb)
    pb = BVH(**{f: torch.from_numpy(np.array(getattr(jb, f))) for f in
                ("bb_min", "bb_max", "first_tri", "tri_count", "skip", "v0", "e1", "e2", "perm")})
    cfg, scene = PTConfig(**AOV_SIZE), build_pt_scene(device=CPU, **kw)
    got = render_aovs(cfg, scene, POS, QUAT, 2, KEY, pb, 1.0)
    hold_aovs(got, want)
    cs = build_clusters(kw["triangles"], tri_mats=kw["tri_mats"], device=CPU)
    via_cs = render_aovs(cfg, scene, POS, QUAT, 2, KEY, cs, 1.0)
    hold_aovs(via_cs, {k: v.numpy() for k, v in got.items()})
    alb = want["albedo"][want["depth"] > 0]
    assert (alb[:, 0] > 0.85).any() and (alb[:, 1] > 0.55).any()  # both materials seen


def denoise_inputs():
    """40x24 planes from a numpy seed: noisy radiance on two surfaces, a
    sky band (depth 0), an emissive patch (albedo 0, radiance 9) and a
    firefly."""
    rng = np.random.default_rng(5)
    h, w = 24, 40
    rad = rng.gamma(2.0, 0.2, (h, w, 3)).astype(np.float32)
    alb = np.tile(np.array([0.7, 0.4, 0.3], np.float32), (h, w, 1))
    alb[:, 20:] = (0.2, 0.6, 0.3)
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[:, :20, 2] = 1.0
    nrm[:, 20:] = (0.0, -0.6, 0.8)
    nrm += rng.normal(0.0, 0.02, nrm.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dep = (5.0 + rng.uniform(0.0, 0.05, (h, w))).astype(np.float32)
    dep[:, 20:] += np.linspace(0.0, 2.0, 20, dtype=np.float32)
    dep[:3] = 0.0
    rad[:3] = 0.4
    alb[:3] = 0.0
    nrm[:3] = 0.0
    alb[10:14, 5:9] = 0.0
    rad[10:14, 5:9] = 9.0
    rad[17, 30] = 400.0
    noise = np.where(rng.uniform(size=(h, w)) < 0.5, 0.0,
                     rng.uniform(0.0, 0.2, (h, w))).astype(np.float32)
    return rad, alb, nrm, dep, noise


@pytest.mark.parametrize("override", [False, True], ids=["local noise", "noise override"])
def test_denoise_matches_jax(override):
    rad, alb, nrm, dep, noise = denoise_inputs()
    kw = dict(noise=noise) if override else {}
    want = np.asarray(jax_denoise(rad, alb, nrm, dep, iterations=3, **kw))
    ins = [torch.from_numpy(x) for x in (rad, alb, nrm, dep)]
    got = denoise(*ins, iterations=3, **({"noise": torch.from_numpy(noise)} if override else {}))
    assert got.device == CPU and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **DENOISE_TOL)
    assert np.array_equal(got[:3].numpy(), rad[:3])  # sky passes through
    assert got[17, 30, 0] < 50.0  # the firefly is clamped
    if override:  # numpy inputs, device named: the same result
        again = denoise(rad, alb, nrm, dep, 3, noise=noise, device="cpu")
        assert torch.equal(again, got)


def test_temporal_step_matches_jax():
    """Four steps (a static pose twice, a small turn, a half turn), each fed
    JAX's AOV planes at that pose and seeded radiance, through JAX's and the
    port's temporal_step; state, output and temporal_noise compared."""
    size = dict(width=48, height=32)
    kw = sphere_kw()
    jcfg, cfg = JPTConfig(**size), PTConfig(**size)
    quats = [np.asarray(QUAT, np.float32)] * 2 + [
        np.array(jax_quat_z(jnp.float32(a)), np.float32) for a in (0.03, np.pi)]
    rng = np.random.default_rng(7)
    jstate, state = jax_temporal.temporal_init(jcfg), temporal_init(cfg, device=CPU)
    flips, kept = [], []
    for k, quat in enumerate(quats):
        aovs = jax_aovs(kw, 2, 0.0, size=size, quat=quat, key=k)
        rad = rng.uniform(0.0, 1.5, (32, 48, 3)).astype(np.float32)
        jstate, jout = jax_temporal.temporal_step(jcfg, jstate, rad, aovs, jnp.asarray(POS),
                                                  jnp.asarray(quat))
        state, out = temporal_step(cfg, state, torch.from_numpy(rad),
                                   {k2: torch.from_numpy(v) for k2, v in aovs.items()},
                                   torch.tensor(POS), torch.from_numpy(quat))
        # a pixel whose validity flips restarts its history in one package
        # only: its length differs by a whole frame or more
        bad = ~np.isclose(state.length.numpy(), np.asarray(jstate.length), atol=1e-5, rtol=1e-5)
        flips.append(int(bad.sum()))
        keep = ~bad
        for name in ("irr", "depth", "normal", "length", "m1", "m2"):
            g, w = getattr(state, name).numpy(), np.asarray(getattr(jstate, name))
            np.testing.assert_allclose(g[keep], w[keep], atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(out.numpy()[keep], np.asarray(jout)[keep], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(temporal_noise(state).numpy()[keep],
                                   np.asarray(jax_temporal.temporal_noise(jstate))[keep],
                                   atol=1e-5, rtol=1e-5)
        hit = aovs["depth"] > 0
        kept.append((state.length.numpy()[hit] >= 2).mean())
    assert sum(flips) <= allowed(32 * 48 * len(quats)), flips
    # the static step and the small turn kept history on most surface
    # pixels; the half turn left none
    assert kept[1] > 0.5 and kept[2] > 0.5 and kept[3] == 0.0, kept


def test_timer_and_profiling(tmp_path):
    """Timer; FrameRecorder.report() has JAX's keys; device_trace writes a
    Chrome trace on the CPU with the stage's annotation in it; the packages
    export what JAX's export."""
    t = Timer()
    for _ in range(2):
        t.start("x")
        assert t.stop("x") >= 0.0
    assert t.counts["x"] == 2 and set(t.summary()) == {"x"}
    assert t.mean("x") == t.totals["x"] / 2 and t.mean("absent") == 0.0
    reports = []
    for mod in (profiling, jax_profiling):
        rec = mod.FrameRecorder(100, 20)
        assert rec.report() == {}
        with rec.frame():
            pass
        reports.append(rec.report())
    assert set(reports[0]) == set(reports[1])
    assert reports[0]["primary_rays"] == 100 and reports[0]["frames"] == 1
    rec.dump(str(tmp_path / "r.json"))
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.stage("demo stage"):
            torch.ones(64).sum()
    assert any(e.name == "demo stage" for e in prof.events())
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "demo stage" in traces[0].read_text()
    assert (pathtracer.temporal_init, pathtracer.TemporalState, pathtracer.temporal_noise) == (
        temporal.temporal_init, temporal.TemporalState, temporal.temporal_noise)
    assert utils.Timer is Timer
    assert all(callable(getattr(Timer, m)) for m in vars(jax_timing.Timer) if not m.startswith("_"))


def test_device_rules():
    """No card and no device: RuntimeError; inputs on two devices (a meta
    tensor stands in for a CUDA one): ValueError."""
    cfg = PTConfig(width=8, height=8)
    rad, alb, nrm, dep, _ = denoise_inputs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            temporal_init(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            denoise(rad, alb, nrm, dep)
    meta = torch.empty(dep.shape, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        denoise(torch.from_numpy(rad), alb, nrm, meta)
    with pytest.raises(ValueError, match="more than one device"):
        denoise(torch.from_numpy(rad), alb, nrm, dep, device="meta")
    state = temporal_init(cfg, device=CPU)
    planes = {"depth": torch.zeros(8, 8, device="meta"), "normal": np.zeros((8, 8, 3)),
              "albedo": np.zeros((8, 8, 3))}
    with pytest.raises(ValueError, match="more than one device"):
        temporal_step(cfg, state, np.zeros((8, 8, 3)), planes, POS, QUAT)
    scene = build_pt_scene(device=CPU, **sphere_kw())
    with pytest.raises(ValueError, match="more than one device"):
        render_aovs(cfg, scene, torch.zeros(3, device="meta"), QUAT, 1)
    with pytest.raises(TypeError, match="bvh must be"):
        render_aovs(cfg, scene, POS, QUAT, 1, bvh=object())
    assert rtt.pathtracer.render_aovs is render_aovs
