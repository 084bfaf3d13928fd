"""Declarative JSON scene files for the path tracer
(raytracing_engine_tpu/pathtracer/sceneio.py, copied: the JAX package's
module imports JAX).

The reference hardcodes its scene as Rust literals rebuilt per run
(the reference renderer's src/main.rs:524-601); the data-driven analog
here is a small JSON schema that assembles the same PTScene a Python
caller would build via `build_pt_scene`, so scenes are shareable files
instead of code:

```json
{
  "materials": [
    {"albedo": [0.7, 0.6, 0.4]},
    {"albedo": [0, 0, 0], "emission": [10, 10, 10]},
    {"albedo": [0.9, 0.9, 0.9], "kind": "mirror"}
  ],
  "spheres": [
    {"center": [6, 4, 6], "radius": 1.5, "mat": 1}
  ],
  "meshes": [
    {"obj": "bunny.obj", "mat": 0, "scale": 2.0, "translate": [0, 8, 0]},
    {"icosphere": {"subdivisions": 3, "radius": 1.2}, "mat": 2},
    {"knot": {"segments": 400}, "mat": 0, "translate": [0, 8, 0]}
  ],
  "camera": {"position": [0, 0, 0], "quat": [0, 0, 0, 1]},
  "mesh_lights": false
}
```

- `kind` is "diffuse" (default), "mirror", or "dielectric" (smooth glass;
  optional `ior`, default 1.5; optional `dispersion` = ior spread between
  blue and red for chromatic refraction; `albedo` is optional there and
  defaults to [1,1,1] — a clear glass tints nothing).
- `checker`: optional per-material checker texture `{"color": [r,g,b],
  "scale": cells-per-unit, "space": "world"|"uv"}` alternating with
  `albedo` — world-space cells by default, texture-UV cells with
  `"space": "uv"` (needs UV-carrying geometry).
- `kind: "metal"` is a GGX rough conductor: `albedo` is the F0
  reflectance, `roughness` (default 0.3) the perceptual roughness
  (microfacet alpha = roughness²).
- `normal`: optional tangent-space normal map (same png/npy + scale
  schema as `image`; texels encode (n+1)/2) — applied on any geometry
  with UVs (meshes with `"uvs": true`, spheres analytically).
- `image`: optional per-material image texture `{"png": path}` or
  `{"npy": path}` (relative to the JSON file; PNG texels are UNORM
  `u8/255` linear, matching the write path) with optional `"scale"`
  (UV tiling factor). All images share one 128-texel-wide atlas
  (scene.pack_texture_atlas); sampling is nearest-texel at the hit UV.
- `meshes[*]` sources: `obj` (path relative to the JSON file), `icosphere`
  (accel.icosphere kwargs), `knot` (accel.torus_knot kwargs). `scale` and
  `translate` post-transform vertices. Each mesh gets ONE material.
  `"smooth": true` shades the mesh with barycentric-interpolated vertex
  normals (the OBJ's `vn` records when present, else area-weighted
  welded-vertex normals) — requires the cluster path (`bvh=` a ClusterSet).
  `"uvs": true` loads the OBJ's `vt` per-corner texture coordinates
  (loud error if the file has none) for UV-space checkers / image
  textures on the mesh.
- `camera` is optional (origin, identity quat); the JAX package's
  `cli pt --scene f.json` uses it as the starting pose.
- `env`: environment light. `[r, g, b]` (constant) or
  `{"bottom": [r,g,b], "top": [r,g,b]}` (gradient lerped on the ray's z;
  escaped rays read it at full weight, BSDF-sampling-only) — or
  `{"image": <(H,W,3) nested list | path.npy>, "pick": p?, "rows": K?}`:
  an equirect HDR env MAP, NEE-importance-sampled via a luminance alias
  table and MIS-paired with BSDF sampling (scene.build_env_map).
- `mesh_lights: true` routes emissive triangles through the area-CDF
  mesh-light sampler (required when emissive tris exceed the per-slot
  NEE unroll limit — build_pt_scene raises loudly otherwise).
- `instances`: the two-level (config-5 style) path — ONE base mesh
  replicated by a `grid` ({nx, ny, spacing, base}) and/or explicit
  `transforms` ([{translate, rotate_z, scale}, ...]), each instance
  shaded with material `mat`. Mutually exclusive with `meshes` (the
  instanced intersector traces spheres + instances only; a loose mesh
  would silently vanish — the loader refuses instead).

Unknown top-level or per-entry keys raise: a typo that silently dropped a
light would be a wrongness hazard, not a convenience.

In the port every entry of the schema loads and renders, with the JAX
package's checks and messages (``mesh_lights`` as ``build_pt_scene`` takes
it: true, "pass" or "lane"). The scene goes to ``device`` (None: the CUDA
card).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from raytracing_engine_tpu_torch.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    METAL,
    MIRROR,
    PTScene,
    build_pt_scene,
)

_KINDS = {"diffuse": DIFFUSE, "mirror": MIRROR,
          "dielectric": DIELECTRIC, "metal": METAL}
_TOP_KEYS = {"materials", "spheres", "meshes", "camera", "mesh_lights",
             "env", "instances", "tex_mips"}
_MAT_KEYS = {"albedo", "emission", "kind", "ior", "checker",
             "dispersion", "image", "normal", "roughness", "roughness_y"}
_SPH_KEYS = {"center", "radius", "mat"}
_MESH_KEYS = {"obj", "icosphere", "knot", "mat", "scale", "translate",
              "smooth", "uvs"}
_CAM_KEYS = {"position", "quat"}
_INST_KEYS = {"mesh", "mat", "grid", "transforms"}
_GRID_KEYS = {"nx", "ny", "spacing", "base"}
_XFORM_KEYS = {"translate", "rotate_z", "scale"}


def _check_keys(d: dict, allowed: set, what: str) -> None:
    extra = set(d) - allowed
    if extra:
        raise ValueError(f"unknown {what} key(s) {sorted(extra)}; "
                         f"allowed: {sorted(allowed)}")


def _mesh_tris(entry: dict, base_dir: str):
    """-> (tris (T,3,3), vnormals (T,3,3) | None, vuvs (T,3,2) | None).
    Normals are returned only for entries with `"smooth": true` — from
    the OBJ's `vn` records when present, else area-weighted welded-vertex
    normals (accel.mesh.smooth_vertex_normals); UVs only for
    `"uvs": true` (OBJ `vt` records — loud error when absent). Uniform
    scale / translate leave normal directions and UVs unchanged."""
    sources = [k for k in ("obj", "icosphere", "knot") if k in entry]
    if len(sources) != 1:
        raise ValueError(f"mesh entry needs exactly one of obj/icosphere/"
                         f"knot, got {sources or 'none'}")
    src = sources[0]
    smooth = bool(entry.get("smooth", False))
    want_uv = bool(entry.get("uvs", False))
    vn = vuv = None
    if src == "obj":
        from raytracing_engine_tpu_torch.accel import load_obj

        path = entry["obj"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        tris, vn, vuv = load_obj(path, normals=True, uvs=True)
        if not smooth:
            vn = None
        if want_uv and vuv is None:
            raise ValueError(
                f"mesh {entry['obj']!r} sets \"uvs\": true but the OBJ has "
                f"no complete vt/f v/vt texture-coordinate set")
        if not want_uv:
            vuv = None
    else:
        if want_uv:
            raise ValueError(
                f'"uvs": true needs an obj source with vt records; '
                f"{src} meshes carry no parametrization")
        if src == "icosphere":
            from raytracing_engine_tpu_torch.accel import icosphere

            tris = icosphere(**entry["icosphere"])
        else:
            from raytracing_engine_tpu_torch.accel import torus_knot

            tris = torus_knot(**entry["knot"])
    tris = np.asarray(tris, np.float32)
    if smooth and vn is None:
        from raytracing_engine_tpu_torch.accel.mesh import smooth_vertex_normals

        vn = smooth_vertex_normals(tris)
    if "scale" in entry:
        tris = tris * np.float32(entry["scale"])
    if "translate" in entry:
        tris = tris + np.asarray(entry["translate"], np.float32)
    return tris, vn, vuv


class SceneBundle(NamedTuple):
    """What load_scene_json returns — NAMED fields so adding one never
    silently renumbers a positional unpack again (the tri_normals
    addition broke exactly that way). tris/tri_mats/tri_normals/tri_uvs
    feed accel.clusters.build_clusters / accel.build_bvh for the `bvh=`
    path; `instanced` carries {mesh (T,3,3), transforms [(rot3x3, trans3,
    scale)], mat} for accel.instancing.make_instances +
    make_instanced_clusters (mutually exclusive with loose meshes)."""

    scene: PTScene
    tris: np.ndarray | None        # (T, 3, 3) f32 concatenated mesh soup
    tri_mats: np.ndarray | None    # (T,) i32 per-triangle material ids
    cam_pos: np.ndarray            # (3,) f32
    cam_quat: np.ndarray           # (4,) f32
    instanced: dict | None         # two-level spec (see docstring)
    tri_normals: np.ndarray | None  # (T, 3, 3) f32 when any mesh is smooth
    tri_uvs: np.ndarray | None     # (T, 3, 2) f32 when any mesh has UVs


def load_scene_json(path: str, device=None) -> SceneBundle:
    """Load a JSON scene file into a SceneBundle (see schema above); the
    scene is built on `device` (None: the CUDA card, device.resolve), the
    mesh arrays stay numpy.

    tri_normals is non-None when any mesh entry sets `"smooth": true`
    (flat entries then carry face normals per corner, so a mixed scene
    builds ONE smooth cluster table that shades each part correctly);
    tri_uvs likewise when any entry sets `"uvs": true` (UV-less parts
    carry zeros — they read texel (0,0) only if their material is
    image-textured, which the schema has no way to express per-part
    incorrectly since materials are per-mesh).
    """
    with open(path) as f:
        spec = json.load(f)
    if not isinstance(spec, dict):
        raise ValueError(f"{path}: top level must be a JSON object")
    _check_keys(spec, _TOP_KEYS, "scene")
    base_dir = os.path.dirname(os.path.abspath(path))

    materials = []
    for i, m in enumerate(spec.get("materials", [])):
        _check_keys(m, _MAT_KEYS, f"materials[{i}]")
        kind = m.get("kind", "diffuse")
        if kind not in _KINDS:
            raise ValueError(f"materials[{i}].kind {kind!r} not in "
                             f"{sorted(_KINDS)}")
        mat = {"emission": tuple(m.get("emission", (0, 0, 0))),
               "kind": _KINDS[kind], "ior": float(m.get("ior", 1.5)),
               "dispersion": float(m.get("dispersion", 0.0))}
        if "roughness" in m or kind == "metal":
            mat["roughness"] = float(m.get("roughness", 0.3))
        if "roughness_y" in m:  # anisotropic GGX second axis
            mat["roughness_y"] = float(m["roughness_y"])
        if "checker" in m:  # {"color", "scale", "space": "world"|"uv"}
            extra = set(m["checker"]) - {"color", "scale", "space"}
            if extra:
                raise ValueError(f"materials[{i}].checker: unknown keys "
                                 f"{sorted(extra)}")
            space = m["checker"].get("space", "world")
            if space not in ("world", "uv"):
                raise ValueError(f"materials[{i}].checker.space {space!r} "
                                 f"must be 'world' or 'uv'")
            mat["checker"] = {"color": tuple(m["checker"].get(
                "color", (0, 0, 0))), "scale": float(m["checker"].get(
                    "scale", 1.0)), "space": space}
        for key in ("image", "normal"):
            # {"png": path} | {"npy": path} [+ "scale"]; `normal` texels
            # encode the tangent-space normal as (n+1)/2 (standard maps)
            if key not in m:
                continue
            spec_i = m[key]
            extra = set(spec_i) - {"png", "npy", "scale"}
            if extra or ("png" in spec_i) == ("npy" in spec_i):
                raise ValueError(
                    f"materials[{i}].{key} needs exactly one of png/npy "
                    f"(+ optional scale); got {sorted(spec_i)}")
            ipath = spec_i.get("png") or spec_i.get("npy")
            if not os.path.isabs(ipath):
                ipath = os.path.join(base_dir, ipath)
            if "png" in spec_i:
                from raytracing_engine_tpu_torch.utils.image import read_png

                # UNORM u8/255 linear — symmetric with the write path
                pixels = read_png(ipath).astype(np.float32) / 255.0
            else:
                pixels = np.asarray(np.load(ipath), np.float32)
            mat[key] = {"pixels": pixels,
                        "scale": float(spec_i.get("scale", 1.0))}
        if "albedo" in m:
            mat["albedo"] = tuple(m["albedo"])
        elif kind != "dielectric":
            raise ValueError(f"materials[{i}]: albedo is required for "
                             f"kind {kind!r}")
        materials.append(mat)
    n_mat = len(materials)

    def _mat_id(j, what):
        j = int(j)
        if not 0 <= j < n_mat:
            raise ValueError(f"{what}: mat {j} out of range "
                             f"(have {n_mat} materials)")
        return j

    spheres = []
    for i, s in enumerate(spec.get("spheres", [])):
        _check_keys(s, _SPH_KEYS, f"spheres[{i}]")
        spheres.append((tuple(s["center"]), float(s["radius"]),
                        _mat_id(s["mat"], f"spheres[{i}]")))

    tris = tri_mats = tri_normals = tri_uvs = None
    parts, part_mats, part_ns, part_uvs = [], [], [], []
    for i, m in enumerate(spec.get("meshes", [])):
        _check_keys(m, _MESH_KEYS, f"meshes[{i}]")
        t, vn, vuv = _mesh_tris(m, base_dir)
        parts.append(t)
        part_ns.append(vn)
        part_uvs.append(vuv)
        part_mats.append(np.full(len(t), _mat_id(m.get("mat", 0),
                                                 f"meshes[{i}]"), np.int32))
    if parts:
        tris = np.concatenate(parts, axis=0)
        tri_mats = np.concatenate(part_mats, axis=0)
        if any(vn is not None for vn in part_ns):
            # mixed smooth/flat: flat parts store face normals per corner,
            # which interpolate back to exact flat shading
            def _flat(t):
                n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
                ln = np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                                1e-30)
                return np.repeat((n / ln)[:, None, :], 3,
                                 axis=1).astype(np.float32)

            tri_normals = np.concatenate(
                [vn if vn is not None else _flat(t)
                 for t, vn in zip(parts, part_ns)], axis=0)
        if any(uv is not None for uv in part_uvs):
            # mixed UV/UV-less: UV-less parts carry zeros (their materials
            # aren't image-textured — materials are per-mesh)
            tri_uvs = np.concatenate(
                [uv if uv is not None
                 else np.zeros((len(t), 3, 2), np.float32)
                 for t, uv in zip(parts, part_uvs)], axis=0)

    env = spec.get("env")
    env_kw = {}
    if isinstance(env, dict):
        extra = set(env) - {"bottom", "top", "image", "pick", "rows"}
        if extra:
            raise ValueError(f"env: unknown keys {sorted(extra)}")
        if "image" in env:
            # HDR env map with NEE importance sampling: an inline (H, W, 3)
            # nested list, or a path to a .npy radiance array
            img = env["image"]
            if isinstance(img, str):
                img = np.load(os.path.join(base_dir, img))
            if "pick" in env:
                env_kw["env_pick"] = float(env["pick"])
            if "rows" in env:
                env_kw["env_rows"] = int(env["rows"])
            env = np.asarray(img, np.float32)
        else:
            env = (tuple(env.get("bottom", (0, 0, 0))),
                   tuple(env.get("top", (0, 0, 0))))
    scene = build_pt_scene(
        spheres=spheres, triangles=tris, tri_mats=tri_mats,
        materials=materials,
        # bool or the string mode ("pass" / "lane" — per-lane alias NEE)
        mesh_lights=spec.get("mesh_lights", False),
        env=env, tri_uvs=tri_uvs,
        tex_mips=spec.get("tex_mips", False), device=device, **env_kw,
    )

    instanced = None
    if "instances" in spec:
        if parts:
            raise ValueError(
                "'instances' and 'meshes' cannot be combined: the "
                "two-level intersector traces spheres + instances only, "
                "so a loose mesh would silently vanish")
        inst = spec["instances"]
        _check_keys(inst, _INST_KEYS, "instances")
        if "mesh" not in inst:
            raise ValueError("instances.mesh is required")
        _check_keys(inst["mesh"], _MESH_KEYS - {"mat", "smooth"},
                    "instances.mesh")
        imesh, _, iuv = _mesh_tris(inst["mesh"], base_dir)
        imat = _mat_id(inst.get("mat", 0), "instances")
        transforms = []
        if "grid" in inst:
            g = inst["grid"]
            _check_keys(g, _GRID_KEYS, "instances.grid")
            from raytracing_engine_tpu_torch.accel.instancing import _rotation_z

            nx, ny = int(g["nx"]), int(g["ny"])
            spacing = float(g.get("spacing", 3.0))
            base = tuple(g.get("base", (0.0, 10.0, 0.0)))
            for i in range(nx):
                for j in range(ny):
                    theta = 0.7 * (i * ny + j)
                    t = (base[0] + (i - (nx - 1) / 2) * spacing,
                         base[1] + j * spacing,
                         base[2] + 0.4 * ((i + j) % 3))
                    transforms.append((_rotation_z(theta), t, 1.0))
        for k, x in enumerate(inst.get("transforms", [])):
            _check_keys(x, _XFORM_KEYS, f"instances.transforms[{k}]")
            from raytracing_engine_tpu_torch.accel.instancing import _rotation_z

            transforms.append((_rotation_z(float(x.get("rotate_z", 0.0))),
                               tuple(x.get("translate", (0.0, 0.0, 0.0))),
                               float(x.get("scale", 1.0))))
        if not transforms:
            raise ValueError("instances needs a grid or a transforms list")
        instanced = {"mesh": imesh, "transforms": transforms, "mat": imat,
                     "uvs": iuv}

    cam = spec.get("camera", {})
    _check_keys(cam, _CAM_KEYS, "camera")
    cam_pos = np.asarray(cam.get("position", (0.0, 0.0, 0.0)), np.float32)
    cam_quat = np.asarray(cam.get("quat", (0.0, 0.0, 0.0, 1.0)), np.float32)
    if cam_pos.shape != (3,) or cam_quat.shape != (4,):
        raise ValueError("camera.position must be length 3, camera.quat "
                         "length 4")
    return SceneBundle(scene, tris, tri_mats, cam_pos, cam_quat, instanced,
                       tri_normals, tri_uvs)
