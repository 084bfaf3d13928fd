"""Path-tracer scene: spheres, triangles, materials and the NEE light table
(raytracing_engine_tpu/pathtracer/scene.py).

``build_pt_scene`` is the JAX package's host assembly (numpy, copied) for
what the port renders: spheres, triangle slots (all of them stay in the
scene; a mesh of more than ``TRI_UNROLL_MAX`` slots is intersected through
a ClusterSet, and only the first ``TRI_UNROLL_MAX`` slots are unrolled, for
NEE, so an emissive slot at or past it is refused as the JAX package
refuses it), DIFFUSE / MIRROR / smooth DIELECTRIC / METAL (GGX, isotropic
or anisotropic) / emissive materials, world-space checkers, spectral
dispersion, a constant or gradient sky (``env``), and the sphere and
triangle light slots with their power CDF. Every other input raises
NotImplementedError naming the ROADMAP item that brings it.
``pt_scene_from_numpy`` carries a JAX ``PTScene``'s arrays across, so both
packages render the same data.

The optional material columns are None where no material uses them, as in
the JAX package: a scene without them renders the program it rendered
before they existed (the static gates ``has_metal``, ``has_aniso``,
``has_texture``, ``has_dispersion``, ``has_env``).

Material kinds: 0 DIFFUSE, 1 MIRROR, 3 DIELECTRIC, 4 METAL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.device import resolve

DIFFUSE = 0
MIRROR = 1
EMISSIVE = 2  # alias: a diffuse surface whose emission dominates
DIELECTRIC = 3
METAL = 4

TRI_UNROLL_MAX = 32

LIGHT_SPHERE = 0
LIGHT_TRI = 1

# Rec.709 luminance weights: the "power" of power-weighted light selection
_LUM = np.array([0.2126, 0.7152, 0.0722], np.float64)

_LATER = "ROADMAP.md queue 1 item 4, K4 feature"


def _not_yet(what: str, feature: int):
    raise NotImplementedError(f"{what} is not ported yet ({_LATER} {feature})")


def _pad(a, n, fill=0.0):
    a = np.asarray(a, np.float32)
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, np.float32)
    return np.concatenate([a, pad], axis=0)


_INT_FIELDS = ("sph_mat", "sph_count", "tri_mat", "tri_count", "mat_kind",
               "light_kind", "light_prim", "light_count")


@dataclasses.dataclass
class PTScene:
    # spheres (padded; live rows < sph_count)
    sph_pos: torch.Tensor      # (S, 3) f32
    sph_radius: torch.Tensor   # (S,)
    sph_mat: torch.Tensor      # (S,) int32
    sph_count: torch.Tensor    # () int32
    # triangles (padded): v0 and the edges e1 = v1 - v0, e2 = v2 - v0
    tri_v0: torch.Tensor       # (T, 3)
    tri_e1: torch.Tensor       # (T, 3)
    tri_e2: torch.Tensor       # (T, 3)
    tri_mat: torch.Tensor      # (T,) int32
    tri_count: torch.Tensor    # () int32
    # materials
    mat_albedo: torch.Tensor   # (M, 3)
    mat_emission: torch.Tensor  # (M, 3)
    mat_kind: torch.Tensor     # (M,) int32
    mat_ior: torch.Tensor      # (M,)
    # NEE light table: one slot per emissive primitive, padded
    light_kind: torch.Tensor   # (L,) int32: 0 sphere, 1 triangle
    light_prim: torch.Tensor   # (L,) int32: row in the sphere/triangle table
    light_area: torch.Tensor   # (L,)
    light_le: torch.Tensor     # (L, 3) emitted radiance
    light_count: torch.Tensor  # () int32
    light_pick: torch.Tensor   # (L,) power-weighted selection probability
    light_cdf: torch.Tensor    # (L,) its inclusive CDF; padding pinned to 1
    light_total_power: torch.Tensor  # () sum(area * lum(Le))
    # optional material columns (None: no material uses them; static gates)
    mat_albedo2: torch.Tensor | None = None     # (M, 3) world checker's second color
    mat_tex_scale: torch.Tensor | None = None   # (M,) checker cells per unit; 0 = flat
    mat_rough: torch.Tensor | None = None       # (M,) METAL roughness (alpha = r²)
    mat_rough2: torch.Tensor | None = None      # (M,) METAL roughness_y (anisotropic)
    mat_dispersion: torch.Tensor | None = None  # (M,) DIELECTRIC ior spread, 0 = none
    # gradient sky: (2, 3) [bottom, top] radiance, lerped on the ray's z at
    # 0.5 (d.z + 1); equal rows = a constant sky. Escaped rays read it at
    # full weight (never NEE-sampled)
    env: torch.Tensor | None = None
    # static: any DIELECTRIC material (the scatter step's glass branch)
    has_dielectric: bool = False
    # static: number of triangle light slots
    n_tri_slot_lights: int = 0

    @property
    def device(self) -> torch.device:
        return self.sph_pos.device

    @property
    def has_metal(self) -> bool:
        return self.mat_rough is not None

    @property
    def has_aniso(self) -> bool:
        return self.mat_rough2 is not None

    @property
    def has_texture(self) -> bool:
        return self.mat_tex_scale is not None

    @property
    def has_dispersion(self) -> bool:
        return self.mat_dispersion is not None

    @property
    def has_env(self) -> bool:
        return self.env is not None

    @property
    def has_material_features(self) -> bool:
        """Any of the five optional features: the kernels then launch their
        material instantiation."""
        return (self.has_metal or self.has_aniso or self.has_texture or self.has_dispersion
                or self.has_env)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "PTScene":
        moved = {k: v.to(device) for k, v in self.tensors().items()}
        return dataclasses.replace(self, **moved)


OPTIONAL_FIELDS = ("mat_albedo2", "mat_tex_scale", "mat_rough", "mat_rough2", "mat_dispersion",
                   "env")
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(PTScene)
                      if f.name not in ("has_dielectric", "n_tri_slot_lights")
                      and f.name not in OPTIONAL_FIELDS)


def _scene(arrays: dict, device) -> PTScene:
    device = resolve(device)
    out = {}
    for name in TENSOR_FIELDS + OPTIONAL_FIELDS:
        if arrays.get(name) is None:
            continue
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        out[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(device).contiguous()
    kinds = np.asarray(arrays["mat_kind"])
    lk = np.asarray(arrays["light_kind"])[:int(arrays["light_count"])]
    return PTScene(**out, has_dielectric=bool((kinds == DIELECTRIC).any()),
                   n_tri_slot_lights=int((lk == LIGHT_TRI).sum()))


# JAX PTScene fields this slice does not carry, by the K4 feature of
# ROADMAP.md queue 1 item 4 that brings them; a non-None value raises
_UNPORTED_FIELDS = {
    "mesh_light_tri": 13, "mesh_light_cdf": 13, "mesh_light_area": 13, "mesh_light_pick": 13,
    "mlt_rows": 13, "mlt_smp": 13, "mat_tex_space": 5, "tex_atlas": 5, "mat_tex_rect": 5,
    "mat_tex_mips": 7, "mat_nrm_rect": 6, "mat_nrm_scale": 6, "tri_uv": 5, "lt_center": 12,
    "lt_radius": 12, "lt_power": 12, "lt_cluster": 12, "lt_cdf_intra": 12, "lt_pick_intra": 12,
    "env_img": 8, "env_smp": 8, "env_pick": 8,
}


def pt_scene_from_numpy(fields: dict, device=None) -> PTScene:
    """PTScene from arrays by field name, e.g. the JAX PTScene's fields
    through ``np.asarray`` (its optional columns where they are not None).
    device=None is the CUDA card (device.resolve)."""
    missing = set(TENSOR_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"PTScene fields missing: {sorted(missing)}")
    for name, feature in _UNPORTED_FIELDS.items():
        if fields.get(name) is not None:
            _not_yet(f"PTScene.{name}", feature)
    rough = fields.get("mat_rough")
    if fields.get("has_rough_dielectric") or (
            rough is not None and bool(((np.asarray(fields["mat_kind"]) == DIELECTRIC)
                                        & (np.asarray(rough) > 0)).any())):
        _not_yet("rough dielectric", 3)
    return _scene(fields, device)


def _env_rows(env):
    """The env argument as (2, 3) [bottom, top] rows (or None)."""
    if env is None:
        return None
    e = np.asarray(env, np.float32)
    if e.shape == (3,):
        e = np.stack([e, e])
    if e.shape != (2, 3):
        raise ValueError(f"env must be (3,) or (2, 3) [bottom, top]: shape {e.shape}")
    return e


def build_pt_scene(
    spheres=(),          # sequence of (center(3,), radius, mat_id)
    triangles=None,      # (T, 3, 3) vertex array (v0, v1, v2 per row)
    tri_mats=None,       # (T,) material ids
    materials=(),        # sequence of dicts: albedo(3,), emission(3,), kind, ior
    sphere_pad: int | None = None,
    tri_pad: int | None = None,
    light_pad: int | None = None,
    mesh_lights=False,
    allow_many_tri_lights: bool = False,
    env=None,            # (3,) constant sky or ((3,), (3,)) = (bottom, top) gradient
    tri_uvs=None,
    light_tree: int = 0,
    env_pick=None,
    env_rows=None,
    tex_mips: bool = False,
    device=None,
) -> PTScene:
    """Host-side scene assembly: pads the tables and derives the light table
    (JAX build_pt_scene, the slice's inputs). Material keys: albedo,
    emission, kind, ior, roughness (METAL, default 0.3), roughness_y
    (anisotropic METAL), checker ({"color", "scale", "space": "world"}) and
    dispersion (DIELECTRIC). device=None is the CUDA card."""
    if mesh_lights:
        _not_yet("mesh_lights", 13)
    if env is not None and np.asarray(env, object).ndim == 3:
        _not_yet("env as an (H, W, 3) image (the env map, with env_pick / env_rows)", 8)
    if tri_uvs is not None:
        _not_yet("tri_uvs", 5)
    if light_tree:
        _not_yet("light_tree", 12)
    if tex_mips:
        _not_yet("tex_mips", 7)
    del env_pick, env_rows  # meaningful only with an env map, as in the JAX package
    device = resolve(device)

    S = len(spheres)
    sphere_pad = sphere_pad or max(S, 1)
    sph_pos = np.zeros((sphere_pad, 3), np.float32)
    sph_radius = np.zeros((sphere_pad,), np.float32)
    sph_mat = np.zeros((sphere_pad,), np.int32)
    for i, (c, r, m) in enumerate(spheres):
        sph_pos[i] = c
        sph_radius[i] = r
        sph_mat[i] = m

    if triangles is None:
        triangles = np.zeros((0, 3, 3), np.float32)
        tri_mats = np.zeros((0,), np.int32)
    triangles = np.asarray(triangles, np.float32)
    tri_mats = np.asarray(tri_mats, np.int32)
    T = triangles.shape[0]
    tri_pad = tri_pad or max(T, 1)
    v0 = _pad(triangles[:, 0], tri_pad)
    e1 = _pad(triangles[:, 1] - triangles[:, 0], tri_pad)
    e2 = _pad(triangles[:, 2] - triangles[:, 0], tri_pad)
    tmat = np.zeros((tri_pad,), np.int32)
    tmat[:T] = tri_mats

    M = max(len(materials), 1)
    mat_albedo = np.zeros((M, 3), np.float32)
    mat_emission = np.zeros((M, 3), np.float32)
    mat_kind = np.zeros((M,), np.int32)
    mat_ior = np.ones((M,), np.float32)
    mat_rough = np.zeros((M,), np.float32)
    mat_rough2 = np.zeros((M,), np.float32)
    mat_albedo2 = np.zeros((M, 3), np.float32)
    mat_tex_scale = np.zeros((M,), np.float32)
    mat_dispersion = np.zeros((M,), np.float32)
    for i, m in enumerate(materials):
        if "image" in m:
            _not_yet('material "image" (atlas image textures)', 5)
        if "normal" in m:
            _not_yet('material "normal" (normal maps)', 6)
        mat_kind[i] = m.get("kind", DIFFUSE)
        if mat_kind[i] == DIELECTRIC and m.get("roughness", 0.0) > 0:
            _not_yet('"roughness" on a dielectric (rough dielectric)', 3)
        # a clear dielectric tints nothing: albedo defaults to 1 there
        default_albedo = (1.0,) * 3 if mat_kind[i] == DIELECTRIC else (0.0,) * 3
        mat_albedo[i] = m.get("albedo", default_albedo)
        mat_emission[i] = m.get("emission", (0.0, 0.0, 0.0))
        mat_ior[i] = m.get("ior", 1.5)
        mat_rough[i] = m.get("roughness", 0.3 if mat_kind[i] == METAL else 0.0)
        mat_rough2[i] = m.get("roughness_y", mat_rough[i])
        if "checker" in m:  # {"color": (3,), "scale", "space": "world" | "uv"}
            if m["checker"].get("space", "world") == "uv":
                _not_yet('checker "space": "uv" (UV-space checkers)', 5)
            mat_albedo2[i] = m["checker"].get("color", (0.0, 0.0, 0.0))
            mat_tex_scale[i] = m["checker"].get("scale", 1.0)
        mat_dispersion[i] = m.get("dispersion", 0.0)
    metal = mat_kind == METAL

    # --- light table: all primitives whose material emits -----------------
    lk, lp, la, le = [], [], [], []
    for i in range(S):
        if np.any(mat_emission[sph_mat[i]] > 0):
            lk.append(LIGHT_SPHERE)
            lp.append(i)
            la.append(4.0 * np.pi * float(sph_radius[i]) ** 2)
            le.append(mat_emission[sph_mat[i]])
    for i in range(T):
        if not np.any(mat_emission[tri_mats[i]] > 0):
            continue
        if i >= TRI_UNROLL_MAX and not allow_many_tri_lights:
            raise ValueError(
                f"emissive triangle at slot {i} >= TRI_UNROLL_MAX="
                f"{TRI_UNROLL_MAX}: the unrolled NEE samplers cannot address "
                f"it and it would silently vanish from direct lighting. Move "
                f"emissive triangles into the first {TRI_UNROLL_MAX} slots.")
        lk.append(LIGHT_TRI)
        lp.append(i)
        la.append(0.5 * float(np.linalg.norm(np.cross(e1[i], e2[i]))))
        le.append(mat_emission[tri_mats[i]])
    L = len(lk)
    light_pad = light_pad or max(L, 1)
    light_kind = np.zeros((light_pad,), np.int32)
    light_prim = np.zeros((light_pad,), np.int32)
    light_area = np.ones((light_pad,), np.float32)
    light_le = np.zeros((light_pad, 3), np.float32)
    light_kind[:L] = lk
    light_prim[:L] = lp
    light_area[:L] = la
    if L:
        light_le[:L] = np.stack(le)

    # power-weighted selection table: power = area * lum(Le) per slot
    powers = np.zeros((light_pad,), np.float64)
    for k in range(L):
        powers[k] = la[k] * float(np.dot(le[k], _LUM))
    total_power = float(powers.sum())
    light_pick = (powers / total_power if total_power > 0
                  else powers).astype(np.float32)
    light_cdf = np.minimum(np.cumsum(light_pick), 1.0).astype(np.float32)
    light_cdf[max(L - 1, 0):] = 1.0  # padded slots are never selected

    return _scene(dict(
        sph_pos=sph_pos, sph_radius=sph_radius, sph_mat=sph_mat, sph_count=S,
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_mat=tmat, tri_count=T,
        mat_albedo=mat_albedo, mat_emission=mat_emission, mat_kind=mat_kind,
        mat_ior=mat_ior, light_kind=light_kind, light_prim=light_prim,
        light_area=light_area, light_le=light_le, light_count=L,
        light_pick=light_pick, light_cdf=light_cdf,
        light_total_power=np.float32(total_power),
        # the optional columns, present only where a material uses them
        mat_rough=mat_rough if metal.any() else None,
        mat_rough2=mat_rough2 if (metal & (mat_rough2 != mat_rough)).any() else None,
        mat_albedo2=mat_albedo2 if (mat_tex_scale > 0).any() else None,
        mat_tex_scale=mat_tex_scale if (mat_tex_scale > 0).any() else None,
        mat_dispersion=mat_dispersion if (mat_dispersion > 0).any() else None,
        env=_env_rows(env),
    ), device)
