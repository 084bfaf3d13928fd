"""The port's host-side acceleration structures against the JAX package's.

Meshes (icosphere, torus_knot, smooth normals, OBJ round trips), the BVH
builders (numpy and native, SAH and median) and build_clusters (subtree,
fixed and dp alignments; flat, smooth and UV tables; with materials) must
equal the JAX package's arrays bit for bit (NaN padding included): the port
keeps copies of that host code, and every later comparison of a sweep or a
render assumes both packages hold the same tables.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_engine_tpu.accel import bvh as jbvh
from raytracing_engine_tpu.accel import clusters as jclusters
from raytracing_engine_tpu.accel import mesh as jmesh

from raytracing_engine_tpu_torch.accel import bvh, clusters, mesh
from raytracing_engine_tpu_torch.native import loader

CPU = torch.device("cpu")
MESHES = {"ico3": lambda m: m.icosphere(3), "knot100": lambda m: m.torus_knot(segments=100)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_generators_equal_jax(name):
    got, want = MESHES[name](mesh), MESHES[name](jmesh)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(mesh.smooth_vertex_normals(got), jmesh.smooth_vertex_normals(want))


def test_obj_round_trip_equals_jax(tmp_path):
    tris = mesh.icosphere(1, radius=2.0, center=(0.0, 1.0, 0.0))
    uvs = np.random.default_rng(0).random((tris.shape[0], 3, 2)).astype(np.float32)
    path = str(tmp_path / "m.obj")
    mesh.save_obj(path, tris, uvs=uvs)
    got = mesh.load_obj(path, normals=True, uvs=True)
    want = jmesh.load_obj(path, normals=True, uvs=True)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[0], tris)
    assert got[1] is None and want[1] is None
    assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("method", ["sah", "median"])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_equals_jax(name, native, method):
    tris = MESHES[name](mesh)
    got = bvh.build_bvh(tris, use_native=native, method=method, device=CPU)
    want = jbvh.build_bvh(tris, use_native=native, method=method)
    assert got.builder == ("native" if native else "numpy")
    for field, t in got.tensors().items():
        w = np.asarray(getattr(want, field))
        assert t.device == CPU and t.numpy().dtype == w.dtype, field
        assert np.array_equal(t.numpy(), w), field


def test_native_builder_lands_in_the_package_build_dir():
    assert loader.native_available()
    assert loader.library_path().parent.name == "build"
    assert loader.library_path().parent.parent.name == "raytracing_engine_tpu_torch"
    assert loader.library_path().exists()


def _cluster_kwargs(kind, tris):
    n = tris.shape[0]
    if kind == "smooth":
        return dict(vertex_normals=mesh.smooth_vertex_normals(tris))
    if kind == "uv":
        return dict(vertex_uvs=np.random.default_rng(1).random((n, 3, 2)).astype(np.float32))
    if kind == "mats":
        return dict(tri_mats=(np.arange(n) % 3).astype(np.int32))
    if kind == "median":
        return dict(method="median")
    return dict(align=kind)


@pytest.mark.parametrize("kind", ["subtree", "fixed", "dp", "smooth", "uv", "mats", "median"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_clusters_equals_jax(name, kind):
    """Every field, order_refs included, bit for bit (NaN boxes equal)."""
    tris = MESHES[name](mesh)
    kw = _cluster_kwargs(kind, tris)
    got = clusters.build_clusters(tris, device=CPU, **kw)
    want = jclusters.build_clusters(tris, **kw)
    assert got.builder in ("native", "numpy")
    for field in ("tri", "boxes", "perm", "centroid", "super_boxes", "super_centroid",
                  "order_refs"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g, w, equal_nan=True), field
    for prop in ("num_clusters", "num_super", "padded_tris", "smooth", "has_uv"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_build_clusters_with_a_given_bvh():
    tris = mesh.icosphere(3)
    got = clusters.build_clusters(tris, bvh=bvh.build_bvh(tris, use_native=False, device=CPU),
                                  device=CPU)
    want = jclusters.build_clusters(tris, bvh=jbvh.build_bvh(tris, use_native=False))
    assert got.builder == "given"
    assert np.array_equal(got.tri.numpy(), np.asarray(want.tri), equal_nan=True)


def test_cluster_set_from_numpy_round_trips():
    tris = mesh.torus_knot(segments=100)
    want = jclusters.build_clusters(tris, tri_mats=np.zeros(tris.shape[0], np.int32))
    fields = {f: np.asarray(getattr(want, f)) for f in clusters._FIELDS}
    cs = clusters.cluster_set_from_numpy(fields, device=CPU)
    for f, v in fields.items():
        assert np.array_equal(getattr(cs, f).numpy(), v, equal_nan=True), f
    moved = cs.to(CPU)
    assert moved.num_super == want.num_super and moved.padded_tris == want.padded_tris
    assert cs.perm.dtype == torch.int32 and cs.tri.dtype == torch.float32


def test_visit_orders_equal_jax():
    """Stable near-to-far orders; the same as the JAX package's for origins
    with no distance ties."""
    cs_np = jclusters.build_clusters(mesh.torus_knot(segments=200))
    cs = clusters.cluster_set_from_numpy(
        {f: np.asarray(getattr(cs_np, f)) for f in clusters._FIELDS}, device=CPU)
    origins = np.random.default_rng(2).normal(0.0, 3.0, (5, 3)).astype(np.float32)
    got = clusters.visit_orders(cs, torch.from_numpy(origins)).numpy()
    want = np.asarray(jclusters.visit_orders(cs_np, jnp.asarray(origins)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    one = clusters.visit_order(cs, torch.from_numpy(origins[0])).numpy()
    assert np.array_equal(one, got[0])
    assert sorted(one.tolist()) == list(range(cs.num_super))
