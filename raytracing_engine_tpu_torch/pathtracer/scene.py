"""Path-tracer scene: spheres, triangles, materials and the NEE light table
(raytracing_engine_tpu/pathtracer/scene.py).

``build_pt_scene`` is the JAX package's host assembly (numpy, copied):
spheres, triangle slots (all of them stay in the scene; a mesh of more than
``TRI_UNROLL_MAX`` slots is intersected through a ClusterSet, and only the
first ``TRI_UNROLL_MAX`` slots are unrolled, for NEE, so an emissive slot at
or past it is refused as the JAX package refuses it, unless mesh lights
take every emissive triangle), DIFFUSE / MIRROR / DIELECTRIC (smooth or
rough: GGX, Walter 2007) / METAL (GGX, isotropic or anisotropic) / emissive
materials, checkers in world or UV space, image textures in the shared atlas
(``pack_texture_atlas``), with their box-filtered mip chains packed beside
them (``build_mip_chain``, ``tex_mips=True``: trilinear filtering),
tangent-space normal maps in the same atlas (the ``normal`` material key),
per-corner UVs of the unrolled slots (``tri_uvs``), spectral dispersion, a
constant or gradient sky (``env``) or an importance-sampled equirect env map
(``env`` of shape (H, W, 3): ``build_env_map``), the sphere and triangle
light slots with their power CDF, mesh lights (``mesh_lights``: every
emissive triangle as one light, one area-weighted triangle a pass,
``mesh_light_rows``, or one a lane from alias tables) and the two-level
light tree (``light_tree=C``: ``_build_light_tree``), with every ValueError
of the JAX package. ``pt_scene_from_numpy`` carries a JAX ``PTScene``'s
arrays across, every field of it, so both packages render the same data.

The optional columns and tables are None where nothing uses them, as in
the JAX package: a scene without them renders the program it rendered
before they existed (the static gates ``has_metal``, ``has_aniso``,
``has_texture``, ``has_dispersion``, ``has_env``, ``has_rough_dielectric``,
``has_image``, ``has_tri_uv``, ``needs_uv``, ``has_env_map``,
``has_normal_map``, ``has_mips``, ``needs_tan``, ``has_mesh_light``,
``has_lane_mesh_light``, ``has_light_tree``). The atlas, the env map and
the lane mesh-light tables stay JAX's tables, 128 texels wide with at most
32 rows: their resampling is part of the image, not a layout of the TPU.

Material kinds: 0 DIFFUSE, 1 MIRROR, 3 DIELECTRIC, 4 METAL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.device import resolve
from raytracing_engine_tpu_torch.ops.rng_pcg import MASK, _to_unit, pcg4d, u32

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
MLT_MAX_ROWS = 32    # lane mesh lights: 32 * 128 = 4096 triangles

LIGHT_SPHERE = 0
LIGHT_TRI = 1
LIGHT_MESH = 2  # the pseudo-slot of mesh lights: every emissive triangle, one light

# Rec.709 luminance weights: the "power" of power-weighted light selection
_LUM = np.array([0.2126, 0.7152, 0.0722], np.float64)

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
    # mesh lights (build_pt_scene mesh_lights): every emissive triangle is
    # one light, the light table's LIGHT_MESH pseudo-slot, whose area is the
    # total emissive area, so its pick over that area is the marginal pdf of
    # a point on it. Per pass (mesh_lights True or "pass"): one area-weighted
    # triangle for each global pass (mesh_light_rows) from its rows and
    # their area CDF. Per lane ("lane"): each NEE draw alias-samples its own
    # triangle from 12 K-row blocks [v0, e1, e2, Le] and [alias prob; alias
    # index] rows over the area pmf (padding probability 0)
    mesh_light_tri: torch.Tensor | None = None   # (E, 12) v0, e1, e2, Le
    mesh_light_cdf: torch.Tensor | None = None   # (E,) normalized area CDF
    mesh_light_area: torch.Tensor | None = None  # () total emissive area
    mesh_light_pick: torch.Tensor | None = None  # () the pseudo-slot's pick
    mlt_rows: torch.Tensor | None = None         # (12K, 128) triangle component rows
    mlt_smp: torch.Tensor | None = None          # (2K, 128) [alias prob; alias index]
    # the two-level light tree (light_tree=C, PTConfig.light_sampling
    # "tree"): C clusters of the slots in Morton order, each picked with the
    # weight power / max(dist², radius²) at the shading point, then a slot of
    # the cluster by its power CDF; padded slots carry cluster 0, pick 0 and
    # CDF 1 (_build_light_tree)
    lt_center: torch.Tensor | None = None      # (C, 3) cluster bound centers
    lt_radius: torch.Tensor | None = None      # (C,) cluster bound radii
    lt_power: torch.Tensor | None = None       # (C,) cluster total power
    lt_cluster: torch.Tensor | None = None     # (L,) f32 slot -> cluster
    lt_cdf_intra: torch.Tensor | None = None   # (L,) within-cluster inclusive CDF
    lt_pick_intra: torch.Tensor | None = None  # (L,) within-cluster pick
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
    def has_mesh_light(self) -> bool:
        return self.mesh_light_tri is not None

    @property
    def has_lane_mesh_light(self) -> bool:
        return self.mlt_rows is not None

    @property
    def has_light_tree(self) -> bool:
        return self.lt_center is not None

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
                   "env_smp", "env_pick", "mat_tex_mips", "mat_nrm_rect", "mat_nrm_scale",
                   "mesh_light_tri", "mesh_light_cdf", "mesh_light_area", "mesh_light_pick",
                   "mlt_rows", "mlt_smp", "lt_center", "lt_radius", "lt_power", "lt_cluster",
                   "lt_cdf_intra", "lt_pick_intra")
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


def pt_scene_from_numpy(fields: dict, device=None) -> PTScene:
    """PTScene from arrays by field name, e.g. the JAX PTScene's fields
    through ``np.asarray`` (its optional columns and tables where they are
    not None). device=None is the CUDA card (device.resolve)."""
    missing = set(TENSOR_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"PTScene fields missing: {sorted(missing)}")
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
    PTConfig(tex_filter="trilinear"). device=None is the CUDA card.

    mesh_lights (True or "pass", or "lane") routes every emissive triangle
    through the mesh-light pseudo-slot instead of a slot each (an emissive
    triangle at or past TRI_UNROLL_MAX needs it): one area-weighted
    triangle a pass, or each lane's own from alias tables, at most
    MLT_MAX_ROWS * 128 of them. light_tree=C builds the two-level light
    tree of C clusters over the slot lights (PTConfig.light_sampling
    "tree"); not with mesh_lights."""
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
    emissive_tris = [i for i in range(T) if np.any(mat_emission[tri_mats[i]] > 0)]
    mesh_tri = mesh_cdf = mesh_area = None
    mlt_rows = mlt_smp = None
    mesh_mode = (mesh_lights if isinstance(mesh_lights, str)
                 else ("pass" if mesh_lights else None))
    if mesh_mode not in (None, "pass", "lane"):
        raise ValueError(f"mesh_lights must be bool, 'pass' or 'lane'; got {mesh_lights!r}")
    if mesh_mode:
        if not emissive_tris:
            raise ValueError("mesh_lights=True but no triangle has an emissive material")
        idxs = np.asarray(emissive_tris)
        cross = np.cross(e1[idxs], e2[idxs])
        areas = 0.5 * np.linalg.norm(cross, axis=1).astype(np.float64)
        total = float(areas.sum())
        if total <= 0:
            raise ValueError("emissive triangles have zero total area")
        cols = np.concatenate([v0[idxs], e1[idxs], e2[idxs], mat_emission[tri_mats[idxs]]],
                              axis=1).astype(np.float32)
        if mesh_mode == "pass":
            mesh_tri = cols
            mesh_cdf = np.cumsum(areas / total).astype(np.float32)
            mesh_cdf[-1] = 1.0  # guard fp drift: the last bin covers u -> 1
        else:
            # per lane: a Vose alias table over the area pmf and the
            # triangles' 12 components in lane rows; a point's pdf is area_t /
            # total * 1 / area_t = 1 / total, the per-pass scheme's marginal
            E = len(idxs)
            if E > MLT_MAX_ROWS * ENV_W:
                raise ValueError(
                    f"mesh_lights='lane' holds up to {MLT_MAX_ROWS * ENV_W} emissive triangles "
                    f"(got {E}) — use mesh_lights=True (per-pass, unlimited)")
            K_m = max((E + ENV_W - 1) // ENV_W, 1)
            pmf = np.zeros(K_m * ENV_W, np.float64)
            pmf[:E] = areas / total  # padding stays probability 0
            ap, ai = _alias_table(pmf)
            mlt_rows = np.zeros((12 * K_m, ENV_W), np.float32)
            for c in range(12):
                mlt_rows[c * K_m:(c + 1) * K_m].reshape(-1)[:E] = cols[:, c]
            mlt_smp = np.concatenate([ap.reshape(K_m, ENV_W), ai.reshape(K_m, ENV_W)], axis=0)
        mesh_area = np.float32(total)
        mesh_power = float((areas * (mat_emission[tri_mats[idxs]] @ _LUM)).sum())
        lk.append(LIGHT_MESH)
        lp.append(-1)
        la.append(total)            # the TOTAL area: 1 / (area count) is the
        le.append((0.0, 0.0, 0.0))  # uniform selection's marginal pdf
    else:
        for i in emissive_tris:
            if i >= TRI_UNROLL_MAX and not allow_many_tri_lights:
                raise ValueError(
                    f"emissive triangle at slot {i} >= TRI_UNROLL_MAX="
                    f"{TRI_UNROLL_MAX}: the unrolled NEE samplers cannot address "
                    f"it and it would silently vanish from direct lighting. Pass "
                    f"mesh_lights=True (area-CDF per-pass sampling, no slot limit) "
                    f"or move emissive triangles into the first {TRI_UNROLL_MAX} slots.")
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
    # (the mesh pseudo-slot's: the sum over its triangles)
    powers = np.zeros((light_pad,), np.float64)
    for k in range(L):
        powers[k] = (mesh_power if lk[k] == LIGHT_MESH
                     else la[k] * float(np.dot(le[k], _LUM)))
    total_power = float(powers.sum())
    light_pick = (powers / total_power if total_power > 0
                  else powers).astype(np.float32)
    light_cdf = np.minimum(np.cumsum(light_pick), 1.0).astype(np.float32)
    light_cdf[max(L - 1, 0):] = 1.0  # padded slots are never selected
    mesh_pick = None
    if (mesh_tri is not None or mlt_rows is not None) and total_power > 0:
        mesh_pick = np.float32(mesh_power / total_power)

    lt = None
    if light_tree:
        if mesh_lights:
            raise ValueError(
                "light_tree is incompatible with mesh_lights: the mesh pseudo-slot is sampled "
                "per pass and has no fixed position for the tree's distance term. Use per-slot "
                "triangle lights (<= TRI_UNROLL_MAX) with light_tree, or mesh_lights alone.")
        if L == 0:
            raise ValueError("light_tree > 0 but the scene has no emissive primitives")
        over = [lp[k] for k in range(L) if lk[k] == LIGHT_TRI and lp[k] >= TRI_UNROLL_MAX]
        if over:
            raise ValueError(
                f"light_tree with emissive triangle slots >= TRI_UNROLL_MAX={TRI_UNROLL_MAX} "
                f"(slots {over}): the tree walk can select lights the unrolled point samplers "
                "cannot address (allow_many_tri_lights only defers the hole to render time). "
                f"Keep emissive triangles in the first {TRI_UNROLL_MAX} slots.")
        # slot positions and bounding radii: a sphere's center and radius, a
        # triangle's centroid and farthest corner
        pos = np.zeros((L, 3), np.float64)
        rad = np.zeros((L,), np.float64)
        for k in range(L):
            if lk[k] == LIGHT_SPHERE:
                pos[k] = sph_pos[lp[k]]
                rad[k] = float(sph_radius[lp[k]])
            else:
                i = lp[k]
                cen = v0[i] + (e1[i] + e2[i]) / 3.0
                pos[k] = cen
                rad[k] = max(float(np.linalg.norm(v0[i] - cen)),
                             float(np.linalg.norm(v0[i] + e1[i] - cen)),
                             float(np.linalg.norm(v0[i] + e2[i] - cen)))
        lt = _build_light_tree(pos, rad, powers[:L], int(light_tree), light_pad)

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
        mesh_light_tri=mesh_tri, mesh_light_cdf=mesh_cdf, mesh_light_area=mesh_area,
        mesh_light_pick=mesh_pick, mlt_rows=mlt_rows, mlt_smp=mlt_smp,
        **({} if lt is None else dict(zip(("lt_center", "lt_radius", "lt_power", "lt_cluster",
                                           "lt_cdf_intra", "lt_pick_intra"), lt))),
    ), device)


def _morton3(q):
    """The Morton codes of (N, 3) integer coordinates (10 bits an axis)."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    q = q.astype(np.uint32)
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _build_light_tree(pos, rad, powers, C, light_pad):
    """The two-level light tree over the L slot lights (JAX
    scene._build_light_tree): the slots in Morton order of their positions,
    cut into C contiguous clusters of balanced counts; the slot tables keep
    their order (selection walks the slot axis with a cluster mask).
    -> (center (C, 3), radius (C,), power (C,), cluster (light_pad,),
    cdf_intra (light_pad,), pick_intra (light_pad,)); padded slots carry
    cluster 0, pick 0 and CDF 1."""
    L = pos.shape[0]
    C = max(1, min(int(C), L))
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-12)
    q = np.clip(((pos - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.int64)
    order = np.argsort(_morton3(q), kind="stable")

    cluster = np.zeros((light_pad,), np.float32)
    bounds = np.linspace(0, L, C + 1).round().astype(int)
    for c in range(C):
        for j in order[bounds[c]:bounds[c + 1]]:
            cluster[j] = float(c)

    center = np.zeros((C, 3), np.float32)
    radius = np.zeros((C,), np.float32)
    cpow = np.zeros((C,), np.float64)
    pick = np.zeros((light_pad,), np.float32)
    cdf = np.ones((light_pad,), np.float32)  # padding pinned to 1
    for c in range(C):
        members = [k for k in range(L) if cluster[k] == c]
        mp = pos[members]
        center[c] = mp.mean(axis=0)
        radius[c] = max(float(np.linalg.norm(mp[i] - center[c]) + rad[k])
                        for i, k in enumerate(members))
        cpow[c] = sum(powers[k] for k in members)
        # the members' power CDF in slot order; uniform where the cluster
        # has no power
        n = len(members)
        w = [powers[k] / cpow[c] if cpow[c] > 0 else 1.0 / n for k in members]
        run = 0.0
        for i, k in enumerate(members):
            run += w[i]
            pick[k] = w[i]
            cdf[k] = min(run, 1.0)
        cdf[members[-1]] = 1.0  # guard fp drift: the walk must end in the cluster
    return center, radius, cpow.astype(np.float32), cluster, cdf, pick


def mesh_light_rows(scene: PTScene, seed, gpass):
    """The per-pass mesh-light rows (JAX scene.mesh_light_rows): (N, 14)
    float32 [v0, e1, e2, Le, total area, pick] for the global passes gpass
    (an int, a sequence or an integer tensor). Each pass's triangle is the
    area CDF's first bin (side left) at the uniform of one pcg4d(gpass,
    0x9E3779B9, 0, seed) draw, a stream no pixel reaches, so the choice
    does not depend on chunks, bands or tiles. Computed on the scene's
    device, without a host copy."""
    dev = scene.device
    if isinstance(gpass, torch.Tensor):
        gp = gpass.to(device=dev, dtype=torch.int64).reshape(-1)
    elif isinstance(gpass, (int, np.integer)):
        gp = torch.full((1,), int(gpass), dtype=torch.int64, device=dev)
    else:
        gp = torch.as_tensor(np.asarray(gpass, np.int64).reshape(-1), device=dev)
    gp = gp & MASK
    o1, _, _, _ = pcg4d(gp, torch.full_like(gp, 0x9E3779B9), torch.zeros_like(gp),
                        torch.full_like(gp, u32(seed)))
    cdf = scene.mesh_light_cdf
    e = torch.searchsorted(cdf, _to_unit(o1), right=False).clamp_max(cdf.shape[0] - 1)
    rows = scene.mesh_light_tri[e]
    n = rows.shape[0]
    pick = (scene.mesh_light_pick if scene.mesh_light_pick is not None
            else torch.ones((), dtype=torch.float32, device=dev))
    return torch.cat([rows, scene.mesh_light_area.expand(n, 1), pick.expand(n, 1)], 1)


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
