"""Path-tracer scene: spheres, triangles, materials and the NEE light table
(raytracing_engine_tpu/pathtracer/scene.py).

``build_pt_scene`` is the JAX package's host assembly (numpy, copied) for
what the port renders: spheres, triangle slots (all of them stay in the
scene; a mesh of more than ``TRI_UNROLL_MAX`` slots is intersected through
a ClusterSet, and only the first ``TRI_UNROLL_MAX`` slots are unrolled, for
NEE, so an emissive slot at or past it is refused as the JAX package
refuses it), DIFFUSE / MIRROR / DIELECTRIC (smooth or rough: GGX, Walter
2007) / METAL (GGX, isotropic or anisotropic) / emissive materials,
checkers in world or UV space, image textures in the shared atlas
(``pack_texture_atlas``), with their box-filtered mip chains packed beside
them (``build_mip_chain``, ``tex_mips=True``: trilinear filtering),
tangent-space normal maps in the same atlas (the ``normal`` material key),
per-corner UVs of the unrolled slots (``tri_uvs``), spectral dispersion, a constant or gradient sky (``env``) or
an importance-sampled equirect env map (``env`` of shape (H, W, 3):
``build_env_map``), and the sphere and triangle light slots with their
power CDF. Every other input raises NotImplementedError naming the ROADMAP
item that brings it. ``pt_scene_from_numpy`` carries a JAX ``PTScene``'s
arrays across, so both packages render the same data.

The optional columns and tables are None where nothing uses them, as in
the JAX package: a scene without them renders the program it rendered
before they existed (the static gates ``has_metal``, ``has_aniso``,
``has_texture``, ``has_dispersion``, ``has_env``, ``has_rough_dielectric``,
``has_image``, ``has_tri_uv``, ``needs_uv``, ``has_env_map``,
``has_normal_map``, ``has_mips``, ``needs_tan``). The atlas
and the env map stay JAX's tables, 128 texels wide with at most 32 rows:
their resampling is part of the image, not a layout of the TPU.

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

ATLAS_W = 128        # texels per atlas row
ATLAS_MAX_ROWS = 32  # atlas budget: 32 * 128 = 4096 texels
ENV_W = 128          # env-map texels per row
ENV_MAX_ROWS = 32    # env-map polar rows budget

LIGHT_SPHERE = 0
LIGHT_TRI = 1

# Rec.709 luminance weights: the "power" of power-weighted light selection
_LUM = np.array([0.2126, 0.7152, 0.0722], np.float64)

_LATER = "ROADMAP.md queue 1 item 4, K4 feature"


def _not_yet(what: str, feature: int):
    raise NotImplementedError(f"{what} is not ported yet ({_LATER} {feature})")


def build_mip_chain(img):
    """Box-filtered mip chain of an (h, w, 3) image (JAX
    scene.build_mip_chain): level 0 is the image, each next level the 2 x 2
    mean of the previous (an odd side first repeats its last row or column,
    so sides halve rounding up), down to 1 x 1."""
    img = np.asarray(img, np.float32)
    chain = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        h, w = img.shape[:2]
        if h % 2:
            img = np.concatenate([img, img[-1:]], axis=0)
        if w % 2:
            img = np.concatenate([img, img[:, -1:]], axis=1)
        img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2])
        chain.append(img)
    return chain


def pack_texture_atlas(images):
    """Shelf-pack RGB images into the shared texture atlas (JAX
    scene.pack_texture_atlas). images: sequence of (h, w, 3) float arrays,
    each w <= ATLAS_W. -> (atlas (3K, ATLAS_W) f32, channel-major rows, row
    c*K + k; rects (N, 4) f32 [x0, y0, w, h] texel rectangles), K at most
    ATLAS_MAX_ROWS."""
    rects = np.zeros((len(images), 4), np.float32)
    x = y = shelf_h = 0
    placed = []
    for n, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"texture {n} must be (h, w, 3); got {img.shape}")
        h, w = img.shape[:2]
        if w > ATLAS_W:
            raise ValueError(f"texture {n} is {w} texels wide > atlas width {ATLAS_W}")
        if x + w > ATLAS_W:  # new shelf
            y += shelf_h
            x = shelf_h = 0
        rects[n] = (x, y, w, h)
        placed.append((x, y, img))
        shelf_h = max(shelf_h, h)
        x += w
    K = y + shelf_h
    if K > ATLAS_MAX_ROWS:
        raise ValueError(f"textures need {K} atlas rows > budget {ATLAS_MAX_ROWS} "
                         f"({ATLAS_MAX_ROWS * ATLAS_W} texels) — shrink or share textures")
    K = max(K, 1)
    atlas = np.zeros((3 * K, ATLAS_W), np.float32)
    for x0, y0, img in placed:
        h, w = img.shape[:2]
        for c in range(3):
            atlas[c * K + y0:c * K + y0 + h, x0:x0 + w] = img[:, :, c]
    return atlas, rects


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
    # UV texturing: per-corner UVs of the unrolled slots (ClusterSets carry
    # theirs in table rows 32-37), spheres the analytic parametrization;
    # checkers in UV space (mat_tex_space 1) and image textures in the
    # shared atlas, (3K, 128) channel-major rows
    mat_tex_space: torch.Tensor | None = None   # (M,) 1 = UV-space checker
    tex_atlas: torch.Tensor | None = None       # (3K, 128) atlas rows
    mat_tex_rect: torch.Tensor | None = None    # (M, 4) x0, y0, w, h texels; w 0 = none
    tri_uv: torch.Tensor | None = None          # (T, 6) u0, v0, u1, v1, u2, v2
    # trilinear filtering (tex_mips=True with PTConfig.tex_filter="trilinear"):
    # each albedo image's mip chain in the same atlas, L blocks of [x0, y0,
    # w, h] a material; level 0 is mat_tex_rect, and a chain shorter than L
    # repeats its 1 x 1 level
    mat_tex_mips: torch.Tensor | None = None    # (M, 4 L) per-level rects
    # tangent-space normal maps: a rect of the same atlas holding (n + 1) / 2
    # and the UV tiling; the tangent frame comes from the hit's texture-u
    # tangent (the intersectors' `tan` planes)
    mat_nrm_rect: torch.Tensor | None = None    # (M, 4) x0, y0, w, h texels; w 0 = none
    mat_nrm_scale: torch.Tensor | None = None   # (M,) UV tiling
    # gradient sky: (2, 3) [bottom, top] radiance, lerped on the ray's z at
    # 0.5 (d.z + 1); equal rows = a constant sky. Escaped rays read it at
    # full weight (never NEE-sampled)
    env: torch.Tensor | None = None
    # the equirect env map with NEE importance sampling (build_env_map):
    # radiance rows, [p_sel; alias prob; alias index] rows, and the
    # probability that NEE samples the map rather than the light table
    env_img: torch.Tensor | None = None   # (3K, 128)
    env_smp: torch.Tensor | None = None   # (3K, 128)
    env_pick: torch.Tensor | None = None  # () f32
    # static: any DIELECTRIC material (the scatter step's glass branch)
    has_dielectric: bool = False
    # static: any DIELECTRIC with roughness > 0 (the Walter 2007 branch;
    # mat_rough is then present)
    has_rough_dielectric: bool = False
    # static: number of triangle light slots
    n_tri_slot_lights: int = 0

    @property
    def device(self) -> torch.device:
        return self.sph_pos.device

    @property
    def num_sphere_slots(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def num_triangle_slots(self) -> int:
        return self.tri_v0.shape[0]

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
    def has_image(self) -> bool:
        return self.mat_tex_rect is not None

    @property
    def has_atlas(self) -> bool:
        return self.tex_atlas is not None

    @property
    def has_tri_uv(self) -> bool:
        return self.tri_uv is not None

    @property
    def needs_uv(self) -> bool:
        """Shading reads hit UVs (image textures, normal maps or UV-space
        checkers)."""
        return self.tex_atlas is not None or self.mat_tex_space is not None

    @property
    def has_normal_map(self) -> bool:
        return self.mat_nrm_rect is not None

    @property
    def has_mips(self) -> bool:
        return self.mat_tex_mips is not None

    @property
    def n_mip_levels(self) -> int:
        return 0 if self.mat_tex_mips is None else self.mat_tex_mips.shape[1] // 4

    @property
    def needs_tan(self) -> bool:
        """Shading reads the hit's world texture-u tangent: normal maps (the
        tangent frame) or mips (the UV density of the ray-cone LOD)."""
        return self.mat_nrm_rect is not None or self.mat_tex_mips is not None

    @property
    def has_env_map(self) -> bool:
        return self.env_img is not None

    @property
    def has_material_features(self) -> bool:
        """Any of the optional features: the kernels then launch their
        material instantiation."""
        return (self.has_metal or self.has_aniso or self.has_texture or self.has_dispersion
                or self.has_env or self.has_rough_dielectric or self.has_env_map
                or self.mat_tex_space is not None or self.has_image or self.has_tri_uv
                or self.needs_tan)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "PTScene":
        moved = {k: v.to(device) for k, v in self.tensors().items()}
        return dataclasses.replace(self, **moved)


OPTIONAL_FIELDS = ("mat_albedo2", "mat_tex_scale", "mat_rough", "mat_rough2", "mat_dispersion",
                   "mat_tex_space", "tex_atlas", "mat_tex_rect", "tri_uv", "env", "env_img",
                   "env_smp", "env_pick", "mat_tex_mips", "mat_nrm_rect", "mat_nrm_scale")
_STATIC_FIELDS = ("has_dielectric", "has_rough_dielectric", "n_tri_slot_lights")
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(PTScene)
                      if f.name not in _STATIC_FIELDS and f.name not in OPTIONAL_FIELDS)


def _scene(arrays: dict, device) -> PTScene:
    device = resolve(device)
    out = {}
    for name in TENSOR_FIELDS + OPTIONAL_FIELDS:
        if arrays.get(name) is None:
            continue
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        out[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(device).contiguous()
    kinds = np.asarray(arrays["mat_kind"])
    rough = arrays.get("mat_rough")
    lk = np.asarray(arrays["light_kind"])[:int(arrays["light_count"])]
    return PTScene(**out, has_dielectric=bool((kinds == DIELECTRIC).any()),
                   has_rough_dielectric=rough is not None and bool(
                       ((kinds == DIELECTRIC) & (np.asarray(rough) > 0)).any()),
                   n_tri_slot_lights=int((lk == LIGHT_TRI).sum()))


# JAX PTScene fields this slice does not carry, by the K4 feature of
# ROADMAP.md queue 1 item 4 that brings them; a non-None value raises
_UNPORTED_FIELDS = {
    "mesh_light_tri": 13, "mesh_light_cdf": 13, "mesh_light_area": 13, "mesh_light_pick": 13,
    "mlt_rows": 13, "mlt_smp": 13,
    "lt_center": 12, "lt_radius": 12, "lt_power": 12, "lt_cluster": 12, "lt_cdf_intra": 12,
    "lt_pick_intra": 12,
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
    env=None,            # (3,) constant sky, ((3,), (3,)) = (bottom, top) gradient,
    #                      or an (H, W, 3) equirect HDR image -> the env map
    tri_uvs=None,        # (T, 3, 2) per-corner UVs of the unrolled slots
    light_tree: int = 0,
    env_pick=None,       # NEE env-vs-lights probability override (env map)
    env_rows=None,       # env-map polar resolution override (<= 32)
    tex_mips: bool = False,
    device=None,
) -> PTScene:
    """Host-side scene assembly: pads the tables and derives the light table
    (JAX build_pt_scene, the slice's inputs). Material keys: albedo,
    emission, kind, ior, roughness (METAL, default 0.3; a DIELECTRIC's > 0
    makes it rough glass), roughness_y (anisotropic METAL), checker
    ({"color", "scale", "space": "world" | "uv"}), image ({"pixels": (h, w,
    3), "scale": UV tiling} or the pixels alone) and dispersion
    (DIELECTRIC), normal ({"pixels": (h, w, 3) holding (n + 1) / 2, "scale":
    UV tiling} or the pixels alone: a tangent-space normal map). tex_mips
    packs each image's mip chain (build_mip_chain) into the atlas, for
    PTConfig(tex_filter="trilinear"). device=None is the CUDA card."""
    if mesh_lights:
        _not_yet("mesh_lights", 13)
    if light_tree:
        _not_yet("light_tree", 12)
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
    mat_tex_space = np.zeros((M,), np.float32)
    mat_dispersion = np.zeros((M,), np.float32)
    mat_nrm_scale = np.zeros((M,), np.float32)
    images = []   # (material index, (h, w, 3) pixels) for the atlas
    normals = []  # (material index, (h, w, 3) (n + 1) / 2-encoded normal map)
    for i, m in enumerate(materials):
        mat_kind[i] = m.get("kind", DIFFUSE)
        # a clear dielectric tints nothing: albedo defaults to 1 there
        default_albedo = (1.0,) * 3 if mat_kind[i] == DIELECTRIC else (0.0,) * 3
        mat_albedo[i] = m.get("albedo", default_albedo)
        mat_emission[i] = m.get("emission", (0.0, 0.0, 0.0))
        mat_ior[i] = m.get("ior", 1.5)
        mat_rough[i] = m.get("roughness", 0.3 if mat_kind[i] == METAL else 0.0)
        mat_rough2[i] = m.get("roughness_y", mat_rough[i])
        if "checker" in m:  # {"color": (3,), "scale", "space": "world" | "uv"}
            mat_albedo2[i] = m["checker"].get("color", (0.0, 0.0, 0.0))
            mat_tex_scale[i] = m["checker"].get("scale", 1.0)
            mat_tex_space[i] = 1.0 if m["checker"].get("space", "world") == "uv" else 0.0
        if "image" in m:  # {"pixels": (h, w, 3), "scale": uv tiling} | array
            spec = m["image"]
            if isinstance(spec, dict):
                pixels, scale = spec["pixels"], spec.get("scale", 1.0)
            else:
                pixels, scale = spec, 1.0
            images.append((i, np.asarray(pixels, np.float32)))
            mat_tex_scale[i] = scale
        if "normal" in m:  # {"pixels": (h, w, 3) (n + 1) / 2, "scale"} | array
            spec = m["normal"]
            if isinstance(spec, dict):
                pixels, scale = spec["pixels"], spec.get("scale", 1.0)
            else:
                pixels, scale = spec, 1.0
            normals.append((i, np.asarray(pixels, np.float32)))
            mat_nrm_scale[i] = scale
        mat_dispersion[i] = m.get("dispersion", 0.0)
    textured = bool((mat_tex_scale > 0).any())
    uv_space = bool((mat_tex_space > 0).any())
    rough_diel = (mat_kind == DIELECTRIC) & (mat_rough > 0)
    tex_atlas = mat_rect = nrm_rect = mat_mips = None
    if images or normals:
        # albedo images (with their mip chains under tex_mips) and normal
        # maps share one atlas; level 0 of a chain is the image itself, so
        # mat_tex_rect does not change with tex_mips
        chains = [build_mip_chain(img) if tex_mips else [img] for _, img in images]
        flat = [lv for ch in chains for lv in ch]
        tex_atlas, rects = pack_texture_atlas(flat + [img for _, img in normals])
        if images:
            mat_rect = np.zeros((M, 4), np.float32)  # w = 0: no image texture
            L = max(len(ch) for ch in chains)
            if tex_mips:
                mat_mips = np.zeros((M, 4 * L), np.float32)
            off = 0
            for (i, _), ch in zip(images, chains):
                mat_rect[i] = rects[off]
                if tex_mips:
                    for lv in range(L):  # a short chain repeats its 1 x 1 level
                        mat_mips[i, 4 * lv:4 * lv + 4] = rects[off + min(lv, len(ch) - 1)]
                off += len(ch)
        if normals:
            nrm_rect = np.zeros((M, 4), np.float32)  # w = 0: no normal map
            for (i, _), r in zip(normals, rects[len(flat):]):
                nrm_rect[i] = r
    tri_uv6 = None
    if tri_uvs is not None:
        uv_arr = np.asarray(tri_uvs, np.float32)
        if uv_arr.shape != (T, 3, 2):
            raise ValueError(f"tri_uvs must be (T, 3, 2) matching triangles; got "
                             f"{uv_arr.shape} for T={T}")
        tri_uv6 = _pad(uv_arr.reshape(T, 6), tri_pad)

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

    env_img = env_smp = env_pick_v = None
    if env is not None and np.asarray(env, object).ndim == 3:
        env_img, env_smp, env_power = build_env_map(env, rows=env_rows)
        if env_pick is None:
            # default: power-proportional split between the env and the
            # light table (any value in (0, 1] is unbiased)
            env_pick = (1.0 if total_power <= 0
                        else env_power / (env_power + total_power))
        env_pick_v = np.float32(np.clip(env_pick, 1e-3 if L else 1.0, 1.0))
        env = None  # the gradient env and the map are mutually exclusive

    return _scene(dict(
        sph_pos=sph_pos, sph_radius=sph_radius, sph_mat=sph_mat, sph_count=S,
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_mat=tmat, tri_count=T,
        mat_albedo=mat_albedo, mat_emission=mat_emission, mat_kind=mat_kind,
        mat_ior=mat_ior, light_kind=light_kind, light_prim=light_prim,
        light_area=light_area, light_le=light_le, light_count=L,
        light_pick=light_pick, light_cdf=light_cdf,
        light_total_power=np.float32(total_power),
        # the optional columns, present only where a material uses them;
        # mat_rough ships with metal or rough glass, as in the JAX package
        mat_rough=mat_rough if ((mat_kind == METAL).any() or rough_diel.any()) else None,
        mat_rough2=(mat_rough2 if ((mat_kind == METAL) & (mat_rough2 != mat_rough)).any()
                    else None),
        mat_albedo2=mat_albedo2 if textured else None,
        mat_tex_scale=mat_tex_scale if textured else None,
        mat_tex_space=mat_tex_space if uv_space else None,
        tex_atlas=tex_atlas, mat_tex_rect=mat_rect, tri_uv=tri_uv6, mat_tex_mips=mat_mips,
        mat_nrm_rect=nrm_rect, mat_nrm_scale=None if nrm_rect is None else mat_nrm_scale,
        mat_dispersion=mat_dispersion if (mat_dispersion > 0).any() else None,
        env=_env_rows(env), env_img=env_img, env_smp=env_smp, env_pick=env_pick_v,
    ), device)


def _alias_table(p):
    """Vose alias table for the normalized pmf p (N,) (JAX
    scene._alias_table): (accept_prob (N,) f32, alias_index (N,) f32).
    One uniform u samples it: x = u N, j = floor(x), f = x - j; take j if
    f < prob[j], else alias[j]."""
    p = np.asarray(p, np.float64)
    n = p.size
    scaled = p * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        lg = large.pop()
        prob[s] = scaled[s]
        alias[s] = lg
        scaled[lg] = scaled[lg] - (1.0 - scaled[s])
        (small if scaled[lg] < 1.0 else large).append(lg)
    return prob.astype(np.float32), alias.astype(np.float32)


def build_env_map(img, rows: int | None = None):
    """Equirect HDR environment map -> its tables (JAX scene.build_env_map).

    img: (H, W, 3) radiance, θ from +z (top row) to -z (bottom row), φ over
    the full azimuth with u = 0.5 at +x (the parametrization of the
    spheres' UVs). Resampled (nearest) to (K, ENV_W) with K = min(rows or
    H, ENV_MAX_ROWS). -> (env_img (3K, 128) channel-major radiance rows,
    env_smp (3K, 128) = [p_sel; alias prob; alias index] rows, p_sel each
    texel's selection probability ∝ luminance × solid angle, floored so
    every texel with energy stays samplable; env_power ∫ lum(L) dω, the
    default NEE pick weight)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"env map must be (H, W, 3); got {img.shape}")
    H, W = img.shape[:2]
    K = min(rows or H, ENV_MAX_ROWS)
    iy = np.minimum(((np.arange(K) + 0.5) / K * H).astype(np.int64), H - 1)
    ix = np.minimum(((np.arange(ENV_W) + 0.5) / ENV_W * W).astype(np.int64), W - 1)
    tex = img[iy][:, ix]  # (K, 128, 3) nearest resample
    lum = tex @ _LUM      # (K, 128) float64
    # texel solid angle: (2π/W) * (cos θ_top - cos θ_bot) per row
    th = np.arange(K + 1) / K * np.pi
    domega = (2.0 * np.pi / ENV_W) * (np.cos(th[:-1]) - np.cos(th[1:]))
    w = lum * domega[:, None]
    env_power = float(w.sum())
    # floor: texels with any energy stay samplable, and an all-black map builds
    w = w + max(env_power, 1e-12) * 1e-4 * (domega[:, None] / (4 * np.pi))
    p_sel = (w / w.sum()).astype(np.float32)
    ap, ai = _alias_table(p_sel.reshape(-1))
    env_img = np.concatenate([tex[:, :, c] for c in range(3)], axis=0)
    env_smp = np.concatenate([p_sel, ap.reshape(K, ENV_W), ai.reshape(K, ENV_W)], axis=0)
    return env_img.astype(np.float32), env_smp.astype(np.float32), env_power
