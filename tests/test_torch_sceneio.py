"""The port's JSON scene files (pathtracer/sceneio.py) against the JAX
package's on the CPU.

- examples/showcase.json: every PTScene array, tris, tri_mats, tri_normals,
  cam_pos and cam_quat equal JAX's bundle exactly; the card is the default
  device (without CUDA the call raises unless it is given device="cpu");
- the schema errors of tests/test_sceneio.py:108 and the loader's other
  refusals raise ValueError with JAX's messages;
- an OBJ path relative to the JSON file; an `instances` block gives the
  same instance spec and InstancedClusters table as JAX's;
- the entries that once stood for features still to port (UV checkers,
  images, normal maps, OBJ UVs, the env map, tex_mips, rough glass, each
  with mesh lights) load to JAX's scene field for field, and the mesh
  lights' file renders bit for bit the render of JAX's scene carried
  across (pt_scene_from_numpy);
- the showcase at 48x27 through a smooth ClusterSet: the plain
  render_pt_fast and render_pt_mega against JAX's render_pt_fast(bvh=cs,
  rng="pcg") within the bounds of tests/test_megakernel.py:37-40 (one
  interpret-mode cluster_intersect compile on the JAX side).

Six tests (at most seven: the file queues behind tests/test_rebin.py under
pytest-xdist's loadfile scheduling). chip_smoke.py phase 19 renders the
showcase on the card.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel import build_bvh as jax_build_bvh
from raytracing_engine_tpu.accel import icosphere as jax_icosphere
from raytracing_engine_tpu.accel import save_obj as jax_save_obj
from raytracing_engine_tpu.accel.clusters import build_clusters as jax_build_clusters
from raytracing_engine_tpu.accel.instancing import make_instanced_clusters as jax_mic
from raytracing_engine_tpu.accel.instancing import make_instances as jax_make_instances
from raytracing_engine_tpu.pathtracer.integrator import PTConfig as JPTConfig
from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json as jax_load
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as jax_render_pt_fast

from raytracing_engine_tpu_torch.accel import (
    build_bvh,
    build_clusters,
    make_instanced_clusters,
    make_instances,
)
from raytracing_engine_tpu_torch.ops.cuda import pt
from raytracing_engine_tpu_torch.ops.rng_pcg import seed_from_int
from raytracing_engine_tpu_torch.pathtracer import PTConfig, load_scene_json, wavefront
from raytracing_engine_tpu_torch.pathtracer.scene import (
    OPTIONAL_FIELDS,
    TENSOR_FIELDS,
    pt_scene_from_numpy,
)
from raytracing_engine_tpu_torch.utils.image import write_png

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHOWCASE = os.path.join(os.path.dirname(__file__), "..", "examples", "showcase.json")
SIZE = dict(width=48, height=27, max_bounces=3)


def _write(tmp_path, spec, name="scene.json"):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump(spec, f)
    return p


def assert_bundles_equal(got, want):
    """The port's SceneBundle against JAX's: every array exactly."""
    for f in dataclasses.fields(want.scene):
        v = getattr(want.scene, f.name)
        if v is None or isinstance(v, (bool, int)):
            continue
        assert f.name in TENSOR_FIELDS + OPTIONAL_FIELDS, f.name
        np.testing.assert_array_equal(getattr(got.scene, f.name).numpy(), np.asarray(v),
                                      err_msg=f.name)
    for name in OPTIONAL_FIELDS:
        assert (getattr(got.scene, name) is None) == (getattr(want.scene, name) is None), name
    assert got.scene.has_dielectric == want.scene.has_dielectric
    for name in ("tris", "tri_mats", "tri_normals", "tri_uvs", "cam_pos", "cam_quat"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_showcase_bundle_equals_jax(monkeypatch):
    got = load_scene_json(SHOWCASE, device="cpu")
    want = jax_load(SHOWCASE)
    assert_bundles_equal(got, want)
    sc = got.scene
    assert sc.device == CPU
    assert (sc.has_metal, sc.has_aniso, sc.has_texture, sc.has_dispersion, sc.has_env) == (
        True, False, True, True, True)
    assert got.tris.shape == (320, 3, 3) and got.instanced is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scene_json(SHOWCASE)


# tests/test_sceneio.py:108's cases, and the loader's other refusals
SCHEMA_ERRORS = [
    {"material": []},
    {"materials": [{"albedo": [1, 1, 1], "colour": 1}]},
    {"materials": [{"albedo": [1, 1, 1], "kind": "glass"}]},
    {"materials": [], "spheres": [{"center": [0, 0, 0], "radius": 1, "mat": 0}]},
    {"materials": [{"albedo": [1, 1, 1]}], "meshes": [{"mat": 0}]},
    {"materials": [{"albedo": [1, 1, 1]}], "camera": {"pos": [0, 0, 0]}},
    {"materials": [{"kind": "metal"}]},
    {"materials": [{"albedo": [1, 1, 1], "checker": {"space": "polar"}}]},
    {"materials": [{"albedo": [1, 1, 1], "checker": {"colour": [0, 0, 0]}}]},
    {"materials": [{"albedo": [1, 1, 1], "image": {"png": "a.png", "npy": "a.npy"}}]},
    {"materials": [{"albedo": [1, 1, 1]}], "env": {"sky": [0, 0, 0]}},
    {"materials": [{"albedo": [1, 1, 1]}],
     "meshes": [{"icosphere": {"subdivisions": 1}, "uvs": True}]},
    {"materials": [{"albedo": [1, 1, 1]}], "camera": {"position": [0, 0]}},
    {"materials": [{"albedo": [1, 1, 1]}], "instances": {"mat": 0}},
    {"materials": [{"albedo": [1, 1, 1]}],
     "instances": {"mesh": {"icosphere": {"subdivisions": 1}}}},
    [1, 2],
]


def test_schema_errors_match_jax(tmp_path):
    for k, spec in enumerate(SCHEMA_ERRORS):
        p = _write(tmp_path, spec, f"bad{k}.json")
        with pytest.raises(ValueError) as want:
            jax_load(p)
        with pytest.raises(ValueError) as got:
            load_scene_json(p, device="cpu")
        assert str(got.value) == str(want.value), spec


def test_obj_path_relative_to_json(tmp_path):
    sub = tmp_path / "assets"
    os.makedirs(str(sub))
    jax_save_obj(str(sub / "ball.obj"), jax_icosphere(subdivisions=1))
    p = _write(sub, {"materials": [{"albedo": [0.5, 0.5, 0.5]}],
                     "meshes": [{"obj": "ball.obj", "mat": 0, "smooth": True,
                                 "scale": 1.5, "translate": [0, 5, 0]}]})
    got = load_scene_json(p, device="cpu")
    assert got.tris.shape[0] == 80
    assert_bundles_equal(got, jax_load(p))


def test_instances_block(tmp_path):
    spec = {
        "materials": [{"albedo": [0.6, 0.5, 0.4]},
                      {"albedo": [0, 0, 0], "emission": [10, 10, 10]}],
        "spheres": [{"center": [3, 4, 4], "radius": 0.8, "mat": 1}],
        "instances": {
            "mesh": {"icosphere": {"subdivisions": 1, "radius": 0.8}},
            "mat": 0,
            "grid": {"nx": 2, "ny": 2, "spacing": 2.0, "base": [0, 7, 0]},
            "transforms": [{"translate": [0, 5, -1], "rotate_z": 0.4, "scale": 1.5}],
        },
    }
    p = _write(tmp_path, spec)
    got, want = load_scene_json(p, device="cpu"), jax_load(p)
    assert_bundles_equal(got, want)
    gi, wi = got.instanced, want.instanced
    assert gi["mat"] == wi["mat"] and len(gi["transforms"]) == len(wi["transforms"]) == 5
    np.testing.assert_array_equal(gi["mesh"], wi["mesh"])
    for (r, t, s), (jr, jt, js) in zip(gi["transforms"], wi["transforms"]):
        np.testing.assert_array_equal(r, jr)
        assert tuple(t) == tuple(jt) and s == js
    mats = np.full(5, gi["mat"], np.int32)
    tri_mats = np.full(len(gi["mesh"]), gi["mat"], np.int32)
    jb = jax_build_bvh(wi["mesh"], use_native=False)
    jic = jax_mic(jax_make_instances(jb, wi["transforms"], mats=mats),
                  jax_build_clusters(wi["mesh"], bvh=jb, tri_mats=tri_mats), scene=want.scene)
    pb = build_bvh(gi["mesh"], use_native=False, device=CPU)
    ic = make_instanced_clusters(make_instances(pb, gi["transforms"], mats=mats, device=CPU),
                                 build_clusters(gi["mesh"], bvh=pb, tri_mats=tri_mats,
                                                device=CPU), scene=got.scene, device=CPU)
    np.testing.assert_array_equal(ic.inst_tab.numpy(), np.asarray(jic.inst_tab))
    bad = dict(spec, meshes=[{"icosphere": {"subdivisions": 1}, "mat": 0}])
    with pytest.raises(ValueError, match="instances"):
        load_scene_json(_write(tmp_path, bad, "bad.json"), device="cpu")


def test_unported_entries_load_then_refuse(tmp_path):
    """Each file loads to JAX's scene, field for field (the name stays from
    when the port refused them; every case holds an emissive mesh under
    mesh_lights), and the mesh lights' file renders bit for bit the render
    of JAX's scene carried across."""
    write_png(str(tmp_path / "tex.png"), np.full((2, 2, 3), 0.5, np.float32))
    np.save(str(tmp_path / "nrm.npy"), np.full((2, 2, 3), 0.5, np.float32))
    tris = jax_icosphere(subdivisions=1)
    uvs = np.zeros((len(tris), 3, 2), np.float32)
    jax_save_obj(str(tmp_path / "uv.obj"), tris, uvs=uvs)
    ball = {"center": [0, 5, 0], "radius": 1, "mat": 0}
    base = {"albedo": [0.5, 0.5, 0.5]}
    light = {"albedo": [0, 0, 0], "emission": [5, 5, 5]}

    def mesh_lit(spec):  # with an emissive mesh under mesh_lights
        return dict(spec, mesh_lights=True, materials=spec["materials"] + [light],
                    meshes=spec.get("meshes", []) + [{"icosphere": {"subdivisions": 1},
                                                      "mat": len(spec["materials"])}])

    cases = {
        "uv checker": mesh_lit({"materials": [dict(base, checker={"scale": 2, "space": "uv"},
                                                   normal={"npy": "nrm.npy"})],
                                "spheres": [ball]}),
        "image": mesh_lit({"materials": [dict(base, image={"png": "tex.png"})],
                           "spheres": [ball], "tex_mips": True}),
        "normal": mesh_lit({"materials": [dict(base, normal={"npy": "nrm.npy"})],
                            "spheres": [ball]}),
        "obj uvs": mesh_lit({"materials": [dict(base, normal={"npy": "nrm.npy"})],
                             "meshes": [{"obj": "uv.obj", "uvs": True}]}),
        "env map": {"materials": [base, light], "spheres": [ball], "mesh_lights": True,
                    "meshes": [{"icosphere": {"subdivisions": 1}, "mat": 1}],
                    "env": {"image": np.ones((2, 4, 3)).tolist(), "pick": 0.5, "rows": 2}},
        "mesh lights": {"materials": [base, light], "mesh_lights": True,
                        "meshes": [{"icosphere": {"subdivisions": 1}, "mat": 1}]},
        "tex_mips": mesh_lit({"materials": [base], "spheres": [ball], "tex_mips": True}),
        "rough dielectric": mesh_lit({"materials": [{"kind": "dielectric", "roughness": 0.2},
                                                    dict(base, normal={"npy": "nrm.npy"})],
                                      "spheres": [ball]}),
    }
    for name, spec in cases.items():
        p = _write(tmp_path, spec, f"{name.replace(' ', '_')}.json")
        want, got = jax_load(p), load_scene_json(p, device="cpu")
        assert want.scene.has_mesh_light and got.scene.has_mesh_light, name
        for f in dataclasses.fields(want.scene):
            w, g = getattr(want.scene, f.name), getattr(got.scene, f.name)
            if w is None or isinstance(w, (bool, int)):
                assert g == w, (name, f.name)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {f.name}")
    # the mesh lights' file through render_pt_fast over a raw BVH, bit for bit
    # the same render of JAX's scene carried across
    p = os.path.join(str(tmp_path), "mesh_lights.json")
    got, want = load_scene_json(p, device="cpu"), jax_load(p)
    carried = pt_scene_from_numpy(
        {f.name: np.asarray(getattr(want.scene, f.name)) for f in dataclasses.fields(want.scene)
         if getattr(want.scene, f.name) is not None
         and not isinstance(getattr(want.scene, f.name), (bool, int))}, device="cpu")
    bvh = build_bvh(got.tris, device="cpu")
    cfg = PTConfig(width=16, height=12, max_bounces=2, rng="pcg")
    pos, quat = torch.tensor([0.0, -6.0, 1.0]), torch.tensor([0.0, 0.0, 0.0, 1.0])
    a, na = wavefront.render_pt_fast(cfg, got.scene, pos, quat, 2, 5, bvh=bvh)
    b, nb = wavefront.render_pt_fast(cfg, carried, pos, quat, 2, 5, bvh=bvh)
    assert torch.equal(a, b) and int(na) == int(nb) and a.mean() > 0


def test_showcase_renders_match_jax():
    """48x27, 3 bounces, 2 spp, pcg, through the smooth ClusterSet."""
    got_b = load_scene_json(SHOWCASE, device="cpu")
    want_b = jax_load(SHOWCASE)
    jcs = jax_build_clusters(want_b.tris, tri_mats=want_b.tri_mats,
                             vertex_normals=want_b.tri_normals)
    want, n_want = jax_render_pt_fast(JPTConfig(**SIZE, rng="pcg"), want_b.scene,
                                      jnp.asarray(want_b.cam_pos), jnp.asarray(want_b.cam_quat),
                                      2, jax.random.PRNGKey(13), bvh=jcs)
    want, n_want = np.asarray(want), float(n_want)
    cs = build_clusters(got_b.tris, tri_mats=got_b.tri_mats, vertex_normals=got_b.tri_normals,
                        device=CPU)
    assert cs.smooth
    cfg = PTConfig(**SIZE, rng="pcg")
    pos, quat = torch.from_numpy(got_b.cam_pos), torch.from_numpy(got_b.cam_quat)
    fast = wavefront.render_pt_fast(cfg, got_b.scene, pos, quat, 2, seed=seed_from_int(13),
                                    bvh=cs)
    mega = pt.render_pt_mega(cfg, got_b.scene, pos, quat, 2, seed=seed_from_int(13), bvh=cs)
    for got, n in (fast, mega):
        assert got.shape == (27, 48, 3) and torch.isfinite(got).all()
        d = np.abs(got.numpy() - want).max(-1)
        assert (d > 1e-3).mean() < 0.01, f"{(d > 1e-3).mean():.3%} diverged"
        assert d.mean() < 1e-4, d.mean()
        assert abs(n_want - float(n)) <= max(8.0, 1e-3 * n_want)
    assert 0.05 < want.mean() < 5.0
