"""The port's threefry2x32 stream (ops/rng.py, kernel K9's plain version
and its wrapper ops/cuda/rng.py) against jax.random on the CPU, bit for bit.

Keys: PRNGKey(0), PRNGKey(1) and a key with its high word set; counters and
data from a numpy seed. The layout of jax.random's draws depends on
jax_threefry_partitionable, so the first test asserts it is on. The moments
of tests/test_pallas_rng.py are restated for the port's uniform_planes (the
JAX package's off-TPU stream), and the wrappers' key= and TPU knobs are
checked here at 8x4 pixels. The renders against JAX live in
tests/test_torch_rng_render.py; chip_smoke.py phase 16 holds the kernel
itself to this plain version on the card.

Seven tests, each looping over its cases: under pytest-xdist's loadfile
scheduling a file of 8 or more tests queues ahead of tests/test_rebin.py,
one of the two files that set the suite's wall time.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.extend.random as jex_random
import jax.numpy as jnp

from raytracing_engine_tpu.ops.pallas.rng import key_to_seed as jax_key_to_seed
from raytracing_engine_tpu.ops.pallas.rng import uniform_planes as jax_uniform_planes

from raytracing_engine_tpu_torch.accel import build_clusters, icosphere
from raytracing_engine_tpu_torch.ops import rng
from raytracing_engine_tpu_torch.ops.cuda import common, pt
from raytracing_engine_tpu_torch.ops.cuda import rng as krng
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int, to_int32
from raytracing_engine_tpu_torch.pathtracer import PTConfig, build_pt_scene, scenes, wavefront

torch.set_num_threads(1)
CPU = torch.device("cpu")
KEYS = {"key0": jax.random.PRNGKey(0), "key1": jax.random.PRNGKey(1),
        "high": jnp.array([0x9E3779B9, 0x7F4A7C15], jnp.uint32)}
SHAPE = (3, 17, 33)  # odd sizes: no plane or row lines up with 2^k


def words(name):
    return np.asarray(jax.random.key_data(KEYS[name]))


def test_jax_draws_are_partitionable():
    """The counter layout the port copies; a JAX upgrade that changes it
    shows here first."""
    assert jax.config.jax_threefry_partitionable is True


def test_threefry_fold_in_and_uniform_match_jax():
    ctr = np.random.default_rng(5).integers(0, 2 ** 32, 64, dtype=np.uint64)
    data = [0, 1, 5, 2 ** 31, 2 ** 32 - 3,
            *np.random.default_rng(6).integers(0, 2 ** 32, 4).tolist()]
    for name, key in KEYS.items():
        want = np.asarray(jex_random.threefry_2x32(key, jnp.asarray(ctr, jnp.uint32)))
        y0, y1 = rng.threefry2x32(words(name), ctr[:32], ctr[32:])
        assert np.array_equal(np.concatenate([y0, y1]).astype(np.uint32), want), name
        t0, t1 = rng.threefry2x32(words(name), torch.from_numpy(ctr[:32].astype(np.int64)),
                                  torch.from_numpy(ctr[32:].astype(np.int64)))
        assert np.array_equal(torch.cat([t0, t1]).numpy().astype(np.uint32), want), name
        for x in data:
            folded = np.asarray(jax.random.key_data(jax.random.fold_in(key, x)))
            assert rng.fold_in(words(name), x) == tuple(int(v) for v in folded), (name, x)
        assert rng.key_to_seed(words(name)) == int(jax_key_to_seed(key)), name
        assert rng.key_words(torch.from_numpy(words(name).astype(np.int64))) == rng.key_words(
            words(name))
        bits = np.asarray(jax.random.bits(key, SHAPE))
        assert np.array_equal(rng.random_bits(words(name), *SHAPE).numpy(),
                              bits.astype(np.int64)), name
        uniform = np.asarray(jax.random.uniform(key, SHAPE))
        got = rng.uniform(words(name), *SHAPE)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.uint32), uniform.view(np.uint32)), name
    # an int key is jax.random.PRNGKey(s)
    assert rng.key_words(7) == tuple(int(v) for v in np.asarray(jax.random.PRNGKey(7)))
    assert rng.key_to_seed(1) == seed_from_int(1)


def test_uniform_planes_matches_jax():
    for seed in (0, 42, -7, 2 ** 31 - 1, -2 ** 31):
        want = np.asarray(jax_uniform_planes(jnp.int32(seed), 2, 16, 24))
        got = krng.uniform_planes(seed, 2, 16, 24, device=CPU)
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32)), seed
        # the pallas draw of counter b is uniform_planes(seed + b) in int32
        wrapped = np.asarray(jax_uniform_planes(jnp.int32(seed) + jnp.int32(3), 1, 4, 8))
        got = rng.uniform(rng.planes_key(to_int32(seed + 3)), 1, 4, 8)
        assert np.array_equal(got.numpy(), wrapped), seed


def test_bands_and_the_wrapper(monkeypatch):
    full = rng.uniform(words("high"), 3, 40, 24)
    band = krng.uniform_key(words("high"), 3, 40, 24, row0=17, band_h=9, device=CPU)
    assert torch.equal(band, full[:, 17:26])  # a band is the rows of the full draw
    with pytest.raises(ValueError, match="rows"):
        krng.uniform_key(words("high"), 3, 40, 24, row0=35, band_h=9, device=CPU)
    # on the CPU the wrapper is its plain version and launches nothing
    before = krng.launches
    got = krng.uniform_planes(9, 2, 8, 16, interpret=True, tile=(8, 128), device=CPU)
    assert torch.equal(got, rng.uniform(rng.planes_key(9), 2, 8, 16))
    assert krng.launches == before
    # RngArgs lists the fields of rng::Args in order
    src = (common.CSRC_DIR / "rng.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    assert re.findall(r"(\w+)\s*[,;]", body) == [f for f, _ in krng.RngArgs._fields_]
    # no device means the card, which must exist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        krng.uniform_key(0, 1, 4, 4)


# --- tests/test_pallas_rng.py, restated for the port's uniform_planes --------

def test_uniform_planes_statistics():
    a = krng.uniform_planes(42, 3, 64, 128, device=CPU)
    b = krng.uniform_planes(42, 3, 64, 128, device=CPU)
    c = krng.uniform_planes(43, 3, 64, 128, device=CPU)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 0.1
    assert a.min() >= 0.0 and a.max() < 1.0
    u = krng.uniform_planes(7, 4, 128, 256, device=CPU).double().ravel()
    assert abs(u.mean().item() - 0.5) < 5e-3
    assert abs(u.var().item() - 1.0 / 12.0) < 5e-3
    v = krng.uniform_planes(7, 1, 128, 256, device=CPU)[0]
    assert (v[:16] - v[16:32]).abs().mean() > 0.2


# --- the wrappers' JAX keyword arguments --------------------------------------

TINY = dict(width=8, height=4, max_bounces=2)
QUAT = torch.tensor([0.0, 0.0, 0.0, 1.0])
POS = torch.tensor([0.0, 0.2, 0.0])


def _mesh():
    """icosphere(1) as a ClusterSet in front of the camera, a sphere light."""
    tris = icosphere(subdivisions=1, radius=1.0, center=(0.0, 4.0, 0.0))
    z = np.zeros(len(tris), np.int32)
    scene = build_pt_scene(spheres=[((2.0, 2.0, 2.0), 0.5, 1)], triangles=tris, tri_mats=z,
                           materials=[{"albedo": (0.6, 0.5, 0.4)},
                                      {"albedo": (0, 0, 0), "emission": (8.0,) * 3}],
                           device=CPU)
    return scene, build_clusters(tris, tri_mats=z, device=CPU)


def test_key_equals_the_matching_seed():
    cfg = PTConfig(**TINY, rng="pcg")
    scene = scenes.cornell_box(device=CPU)
    mesh_scene, cs = _mesh()
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(5)))
    for fn, sc, kw in ((wavefront.render_pt_fast, scene, {}), (pt.render_pt_mega, scene, {}),
                       (pt.render_pt_rebin, mesh_scene, dict(bvh=cs))):
        a = fn(cfg, sc, POS, QUAT, 2, seed=seed_from_int(5), spp_offset=1, **kw)
        b = fn(cfg, sc, POS, QUAT, 2, key=key, spp_offset=1, **kw)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
        with pytest.raises(ValueError, match="not both"):
            fn(cfg, sc, POS, QUAT, 1, seed=1, key=key, **kw)
    a = wavefront.trace_pass_soa(cfg, scene, POS, QUAT, seed0=seed_from_int(5))
    b = wavefront.trace_pass_soa(cfg, scene, POS, QUAT, key=torch.tensor([0, 5]))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="key="):
        wavefront.render_pt_fast(PTConfig(**TINY), scene, POS, QUAT, 1, seed=3)


def test_tpu_knobs_are_accepted():
    cfg = PTConfig(**TINY, rng="pcg")
    scene = scenes.cornell_box(device=CPU)
    want, _ = pt.render_pt_mega(cfg, scene, POS, QUAT, 1, key=5)
    got, _ = pt.render_pt_mega(cfg, scene, POS, QUAT, 1, key=5, interpret=True, tile=(8, 128),
                               stripes=2, groups=2, fast_math=True, adaptive_min=4)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="feature 14"):
        pt.render_pt_mega(cfg, scene, POS, QUAT, 1, adaptive_tol=0.01)
    with pytest.raises(NotImplementedError, match="feature 14"):
        pt.render_pt_mega(cfg, scene, POS, QUAT, 1, return_spp=True)
    mesh_scene, cs = _mesh()
    want, _ = pt.render_pt_rebin(cfg, mesh_scene, POS, QUAT, 1, key=5, bvh=cs)
    got, _ = pt.render_pt_rebin(cfg, mesh_scene, POS, QUAT, 1, key=5, bvh=cs, interpret=True,
                                tile=(8, 128), tile_b=(8, 128), stripes=2, fast_math=True,
                                skip_dead=False)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="rng='pcg'"):
        wavefront.render_pt_fast(PTConfig(**TINY), scene, POS, QUAT, 1, sort=True)
