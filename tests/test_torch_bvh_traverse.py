"""The raw BVH on the CPU: the port's skip-link traversal (accel/bvh.py,
kernel K8's plain version) against the JAX package's, and the wavefront's
raw-BVH path.

Rays: one 16x128 grid from a numpy seed. Rows 0-7 aim at the mesh from 2.5
units out, rows 8-11 are axis-parallel (exact +-0 direction components, so
0 * inf = NaN reaches the slab test, some rays in a box face's plane), rows
12-15 are parked at 1e18 as the wavefront parks dead rays. Meshes:
icosphere(2) (320 triangles) and a short torus knot (640). Both packages
traverse the same BVH (the JAX build carried across).

The JAX reference is ``accel.bvh.bvh_intersect``, the jnp traversal: its
packet kernel (ops/pallas/bvh_traverse.py) only runs in interpret mode off
the TPU, at a compile cost this file's budget has no room for, and computes
the same per-ray result (the packet visits a superset of each ray's nodes
with the same strict update). Tolerances: t within rtol 2e-6 / atol 1e-6,
the reordered index equal on at least 99.9% of the rays. XLA contracts the
jitted traversal's sums of products into fused multiply-adds, the port
rounds every product as its kernel does (--fmad=false). The cross products
of Möller-Trumbore cancel, so t moves by up to 1.5e-6 relative (measured:
one ray of the knot's any-hit case, 16 ulps; rtol 1e-6 would not hold it),
and a ray through a shared edge may hit the neighbouring triangle there, at
the same t (one ray of the 2048 on icosphere(2), none on the knot).

render_pt_fast(bvh=BVH) is held to the JAX render_pt_fast with the same
BVH within the megakernel bounds of tests/test_megakernel.py:37-40. Kernel
K8 itself needs the card: chip_smoke.py phase 13 holds it to this plain
version bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import bvh as jbvh
from raytracing_engine_tpu.accel import icosphere
from raytracing_engine_tpu.accel.mesh import torus_knot
from raytracing_engine_tpu.pathtracer import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.scene import build_pt_scene as jax_build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import BVH, bvh_intersect
from raytracing_engine_tpu_torch.ops.cuda import bvh_traverse, common
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import DIFFUSE, PTConfig, build_pt_scene, wavefront

torch.set_num_threads(1)
CPU = torch.device("cpu")
CENTER = np.array([0.0, 5.0, 0.0], np.float32)
H, W = 16, 128
INV_SQRT3 = np.float32(0.5773502691896258)
MESHES = {
    "icosphere": lambda: icosphere(subdivisions=2, radius=1.2, center=tuple(CENTER)),
    "knot": lambda: torus_knot(segments=40, sides=16, radius=0.8, tube=0.25,
                               center=tuple(CENTER)),
}


def _rays(seed=0):
    """(o, d) as (3, 16, 128) float32 arrays; see the module docstring."""
    rng = np.random.default_rng(seed)
    o = np.zeros((3, H, W), np.float32)
    d = np.zeros((3, H, W), np.float32)
    u = rng.normal(size=(3, 8, W))
    u /= np.linalg.norm(u, axis=0)
    o[:, :8] = CENTER[:, None, None] + 2.5 * u
    aim = CENTER[:, None, None] + rng.normal(0.0, 0.5, (3, 8, W)) - o[:, :8]
    d[:, :8] = aim / np.linalg.norm(aim, axis=0)
    for k in range(4 * W):  # axis-parallel rows 8-11
        r, c = 8 + k // W, k % W
        axis, sign = k % 3, (1.0 if (k // 3) % 2 == 0 else -1.0)
        off = rng.uniform(-1.4, 1.4, 3).astype(np.float32)
        off[axis] = -3.0 * sign
        if k % 5 == 0:
            off[(axis + 1) % 3] = 0.0  # the ray runs in a box face's plane
        o[:, r, c] = CENTER + off
        d[:, r, c] = np.where(np.arange(3) == axis, sign, -0.0 if k % 2 else 0.0)
    o[:, 12:] = 1e18
    d[:, 12:] = INV_SQRT3
    return o, d


def _t_max_plane():
    """Per-ray cutoffs for the any-hit case: 1.5 to 3.5, so that some hits
    lie beyond the cutoff."""
    return np.random.default_rng(9).uniform(1.5, 3.5, (H, W)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(MESHES))
def bvhs(request):
    """(name, JAX BVH, the port's BVH with the same arrays)."""
    jb = jbvh.build_bvh(MESHES[request.param]())
    pb = BVH(**{f: torch.from_numpy(np.array(getattr(jb, f))) for f in
                ("bb_min", "bb_max", "first_tri", "tri_count", "skip", "v0", "e1", "e2", "perm")})
    return request.param, jb, pb


def _jax(jb, any_hit):
    o, d = _rays()
    kw = dict(any_hit=True, t_max=jnp.asarray(_t_max_plane())) if any_hit else {}
    out = jbvh.bvh_intersect(jb, jnp.asarray(np.moveaxis(o, 0, -1)),
                             jnp.asarray(np.moveaxis(d, 0, -1)), **kw)
    return [np.asarray(x) for x in out]


def _port(pb, any_hit):
    o, d = _rays()
    kw = dict(any_hit=True, t_max=torch.from_numpy(_t_max_plane())) if any_hit else {}
    out = bvh_intersect(pb, torch.from_numpy(np.moveaxis(o, 0, -1).copy()),
                        torch.from_numpy(np.moveaxis(d, 0, -1).copy()), **kw)
    return [x.numpy() for x in out]


def _hold(got, want):
    """t within rtol 2e-6 / atol 1e-6 everywhere, the same rays hit, and the
    index equal but on shared-edge rays (see the module docstring)."""
    gt, gi, wt, wi = got[0], got[1], want[0], want[1]
    assert gi.dtype == np.int32 and gt.shape == (H, W)
    assert np.array_equal(gi >= 0, wi >= 0) and np.array_equal(np.isinf(gt), np.isinf(wt))
    hit = wi >= 0
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=2e-6, atol=1e-6)
    assert (gi == wi).mean() >= 0.999, f"indices agree on {(gi == wi).mean():.4%} of rays"


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_intersect_matches_jax(bvhs, any_hit):
    _, jb, pb = bvhs
    got, want = _port(pb, any_hit), _jax(jb, any_hit)
    _hold(got, want)
    hit = got[1][:8] >= 0
    assert 0.05 < hit.mean() < 1.0
    if not any_hit:
        same = (got[1] == want[1]) & (want[1] >= 0)  # the barycentric u of each hit
        np.testing.assert_allclose(got[2][same], want[2][same], atol=1e-5)


def test_axis_parallel_and_parked_rows(bvhs):
    _, jb, pb = bvhs
    got, want = _port(pb, False), _jax(jb, False)
    rows = got[1][8:12] >= 0
    assert rows.any() and not rows.all()
    assert np.all(got[1][12:] == -1) and np.all(np.isinf(got[0][12:]))
    anyh = _port(pb, True)
    assert np.all(anyh[1][12:] == -1)  # a parked ray leaves the root at once


def test_any_hit_blocks_exactly_where_a_hit_is_closer(bvhs):
    _, _, pb = bvhs
    closest, anyh = _port(pb, False), _port(pb, True)
    blocked = anyh[1] >= 0
    np.testing.assert_array_equal(blocked, closest[0] < _t_max_plane())
    assert np.all(anyh[0][blocked] < _t_max_plane()[blocked])


def test_step_cap_stops_the_walk(bvhs):
    _, _, pb = bvhs
    o, d = _rays()
    o3 = torch.from_numpy(np.moveaxis(o, 0, -1).copy())
    d3 = torch.from_numpy(np.moveaxis(d, 0, -1).copy())
    full = bvh_intersect(pb, o3, d3)
    one = bvh_intersect(pb, o3, d3, max_steps=1)  # the root only: no leaf reached
    assert (full[1] >= 0).any() and torch.all(one[1] == -1)


def test_wrapper_on_cpu_is_its_plain_version(bvhs):
    _, _, pb = bvhs
    o, d = _rays(1)
    o, d = tuple(torch.from_numpy(x) for x in o), tuple(torch.from_numpy(x) for x in d)
    tables = bvh_traverse.pack_bvh_tables(pb, device="cpu")
    before = bvh_traverse.launches
    bvh_traverse.work.update(nodes=0, tests=0)
    for any_hit, t_max in ((False, float("inf")), (True, 3.0)):
        got = bvh_traverse.bvh_intersect_packet(tables, o, d, t_max, any_hit=any_hit,
                                                tile=(8, 128))
        want = bvh_intersect(pb, torch.stack(o, -1), torch.stack(d, -1), t_max=t_max,
                             any_hit=any_hit, max_steps=500_000)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bvh_traverse.launches == before
    assert bvh_traverse.work["nodes"] > H * W and bvh_traverse.work["tests"] > 0


def test_pack_bvh_tables_layout(bvhs, monkeypatch):
    _, _, pb = bvhs
    tb = bvh_traverse.pack_bvh_tables(pb, device="cpu")
    n, t = pb.bb_min.shape[0], pb.v0.shape[0]
    assert tb.node_bb.shape == (n, 8) and tb.node_meta.dtype == torch.int32
    assert torch.equal(tb.node_bb[:, :6], torch.cat([pb.bb_min, pb.bb_max], 1))
    assert torch.equal(tb.node_meta[:, :3], torch.stack([pb.first_tri, pb.tri_count, pb.skip], 1))
    assert torch.equal(tb.tri[:, :9], torch.cat([pb.v0, pb.e1, pb.e2], 1))
    assert torch.all(tb.tri[:, 9:] == 0) and tb.tri.shape == (t, 12)
    assert bvh_traverse.tables_of(pb) is bvh_traverse.tables_of(pb)  # built once per BVH
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bvh_traverse.pack_bvh_tables(pb)  # the default is the card


def test_traverse_args_mirror_the_cuda_struct():
    import re

    src = (common.CSRC_DIR / "bvh.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    assert re.findall(r"(\w+)\s*[,;]", body) == [f for f, _ in bvh_traverse.TraverseArgs._fields_]


# --- render_pt_fast with a raw BVH ---------------------------------------------

SIZE = dict(width=32, height=16, max_bounces=2)
QUAT = (0.0, 0.0, 0.0, 1.0)
SEED = 3


def _scene_args():
    """tests/test_torch_rebin.py's mesh scene: icosphere(2), a sphere light, a
    ground sphere; materials alternate over the triangles."""
    tris = MESHES["icosphere"]()
    mats = [{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (8.0,) * 3, "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
            {"albedo": (0.3, 0.7, 0.4), "kind": DIFFUSE}]
    spheres = [((3.0, 3.0, 3.0), 1.0, 1), ((0.0, 5.0, -52.0), 50.0, 2)]
    tri_mats = np.where(np.arange(tris.shape[0]) % 2 == 0, 0, 3).astype(np.int32)
    return dict(spheres=spheres, triangles=tris, tri_mats=tri_mats, materials=mats)


def hold_megakernel_bounds(got, n_got, want, n_want):
    """tests/test_megakernel.py:37-40."""
    d = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
    assert d.mean() < 1e-4
    assert abs(float(n_want) - float(n_got)) <= max(8.0, 1e-3 * float(n_want))


@pytest.fixture(scope="module")
def raw_scene():
    kw = _scene_args()
    jb = jbvh.build_bvh(kw["triangles"])
    pb = BVH(**{f: torch.from_numpy(np.array(getattr(jb, f))) for f in
                ("bb_min", "bb_max", "first_tri", "tri_count", "skip", "v0", "e1", "e2", "perm")})
    img, n = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), jax_build_pt_scene(**kw),
                                jnp.zeros(3), jnp.asarray(QUAT), 1, jax.random.PRNGKey(SEED),
                                bvh=jb)
    scene = build_pt_scene(device=CPU, **kw)
    return scene, pb, (np.asarray(img), float(n))


@pytest.mark.parametrize("packet", [None, True])
def test_render_pt_fast_with_a_bvh_matches_jax(raw_scene, packet):
    scene, pb, (want, n_want) = raw_scene
    cfg = PTConfig(**SIZE, rng="pcg")
    got, n = wavefront.render_pt_fast(cfg, scene, torch.zeros(3), torch.tensor(QUAT), 1,
                                      seed=seed_from_int(SEED), bvh=pb, packet=packet)
    assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
    assert (got.amax(-1) > 0).double().mean() > 0.05
    hold_megakernel_bounds(got.numpy(), int(n), want, n_want)


def test_bvh_hits_gather_the_original_material(raw_scene):
    """The hit's material comes from scene.tri_mat at bvh.perm[idx], the
    original triangle (both kinds of triangle get hit)."""
    scene, pb, _ = raw_scene
    rng = np.random.default_rng(13)
    d = rng.normal(size=(3, 8, 64)).astype(np.float32)
    d[1] = np.abs(d[1]) * 3.0 + 1.0
    d /= np.linalg.norm(d, axis=0)
    o = tuple(torch.zeros(8, 64) for _ in range(3))
    d = tuple(torch.from_numpy(x) for x in d)
    isect = wavefront._intersect(scene, o, d, 1e-3, wavefront._counts(scene), pb)
    tri = isect["is_tri"] & isect["hit"]
    assert tri.any() and set(isect["mat_id"][tri].tolist()) == {0, 3}
    t, ridx, _, _ = bvh_intersect(pb, torch.stack(o, -1), torch.stack(d, -1))
    orig = pb.perm[ridx.clamp_min(0).long()].long()
    assert torch.equal(isect["mat_id"][tri], scene.tri_mat[orig][tri])
    assert torch.equal(isect["t"][tri], t[tri])
