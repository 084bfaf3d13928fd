"""K4 and K5: the path tracer through the CUDA kernels of csrc/pt.cu.

- ``render_pt_mega`` launches ``pt_kernel`` (K4), which replaces
  raytracing_engine_tpu/ops/pallas/pt_kernel.py ``_pt_kernel``: the whole
  path per pixel, for scenes of spheres and up to TRI_UNROLL_MAX unrolled
  triangles (BASELINE configs 2 and 4), spheres and a mesh given as a
  ClusterSet (config 3, ``bvh=``), or spheres and instances of such a mesh
  (config 5's path-traced cell, ``bvh=InstancedClusters``: K7's two-level
  sweep inside the kernel); one instantiation of the kernel for each of
  these mesh kinds (``mesh_kind``), the two with a mesh sweeping it with the
  32 lanes of a warp together.
- ``render_pt_rebin`` launches ``pt_rebin_kernel`` (K5), which replaces
  ``_pt_rebin_kernel``: one launch per bounce over a packed 17-plane ray
  state (one plane more with a dispersive scene's chan, one more with the
  ray cone's tacc under trilinear filtering), with an image-wide
  regroup between launches (``rebin_keys``, a stable ``torch.sort``, then
  ``index_select`` of every plane) and a final
  scatter of the radiance to pixel order. K5 sweeps the mesh with the 32
  lanes of a warp together (csrc/cluster.cuh sweep_warp). The regroup only
  changes which thread runs a ray: every draw is keyed on the pixel
  coordinates the state carries, so the image equals K4's bit for bit.

Both kernels come in a second, material instantiation for scenes with any
of the optional material features (GGX metal, anisotropic metal, rough
glass, checkers in world or UV space, image textures, the unrolled slots'
UVs, dispersion, the gradient sky, the env map:
``PTScene.has_material_features``); a scene without them launches the
instantiations it launched before. The atlas, the env map's tables and the
UV records go to the kernels as tables of their own, read from global
memory. A third instantiation of each (``pt_tex_kernel``,
``pt_rebin_tex_kernel``) adds the texture features that read the hit's
texture-u tangent or a UV table under instances: normal maps, the mip
chains' trilinear filter with its ray-cone state, and instances of a UV
ClusterSet (``uses_tex_instantiation``); the scenes without them launch the
instantiations they launched before.
``_kernel_args`` makes these choices once, as ``PTArgs.material`` and
``PTArgs.tex``: the launch picks the instantiation by them, and the counts
below read them.

The sampling features run in a sampling form of each of these
instantiations (``pt_samp_kernel``, ``pt_samp_tex_kernel``,
``pt_rebin_samp_kernel``, ``pt_rebin_samp_tex_kernel``; ``PTArgs.samp``),
so that the renders without them launch the code they launched before: the
thin lens (``PTConfig.aperture`` > 0) and the R_d sampler
(``sampler="r2"``) in K4 and K5, and K4's adaptive spp
(``render_pt_mega(adaptive_tol > 0)``): one K4 launch a pass, each pixel
tracing while its cell takes passes, then ``pt_cell_kernel``, which
updates each cell's sums and decides whether it takes another pass
(``adapt_pass``); nothing goes back to the host between passes.

A scene on the CPU takes the plain versions, ``render_pt_mega_reference``
and ``render_pt_rebin_reference``; a scene on a CUDA device launches the
kernels or raises. Nothing in a frame reads back to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracing_engine_tpu_torch.accel.clusters import ClusterSet
from raytracing_engine_tpu_torch.accel.instancing import InstancedClusters
from raytracing_engine_tpu_torch.ops.cuda import cluster as kcluster
from raytracing_engine_tpu_torch.ops.cuda import common
from raytracing_engine_tpu_torch.ops.cuda import instanced as kinst
from raytracing_engine_tpu_torch.ops.cuda.cluster import ClusterTables, FrameClusters
from raytracing_engine_tpu_torch.ops.cuda.instanced import FrameInstances, InstanceTables
from raytracing_engine_tpu_torch.ops.rng import pcg_base_seed
from raytracing_engine_tpu_torch.ops.rng_pcg import pass_seed, to_int32
from raytracing_engine_tpu_torch.pathtracer.integrator import PTConfig
from raytracing_engine_tpu_torch.pathtracer.scene import TRI_UNROLL_MAX, PTScene
from raytracing_engine_tpu_torch.pathtracer.wavefront import (
    _trace_core,
    check_supported,
    has_tacc,
    pack_state,
    state_plane_count,
    unpack_state,
)

# K4's instantiations, one a mesh kind, in the order csrc/pt.cuh numbers
# them (kMeshNone, kMeshClusters, kMeshInstances)
MESH_KINDS = ("none", "clusters", "instances")

# kernel launches since the counts were last set to 0 (plain-version calls
# do not count): K4 (in all, by mesh kind, and those of the material and of
# the texture instantiation by mesh kind) and K5 (in all, and of its material
# and texture ones); a texture launch counts as a material launch too
launches = 0
mesh_launches = dict.fromkeys(MESH_KINDS, 0)
material_launches = dict.fromkeys(MESH_KINDS, 0)
tex_launches = dict.fromkeys(MESH_KINDS, 0)
rebin_launches = 0
rebin_material_launches = 0
rebin_tex_launches = 0
# the sampling instantiations' launches (K4's and K5's: the thin lens, R_d,
# adaptive passes) and the cell updates between K4's adaptive passes
sampling_launches = 0
rebin_sampling_launches = 0
adapt_launches = 0

# the kernels stage the scene tables in shared memory (the material table,
# up to 20 + 4 L + 5 columns wide with L mip levels, and the sky's 2 x 4
# floats included)
_MAX_TABLE_BYTES = 48 * 1024
# K5's block (csrc/pt.cu kRebinThreads): the "tile" of the tile_oct regroup key
REBIN_TILE = 256


class PTArgs(ctypes.Structure):
    """Mirror of ``pt::Args`` (csrc/pt.cuh), field for field."""

    _fields_ = [
        ("cam_pos", ctypes.c_void_p),
        ("cam_quat", ctypes.c_void_p),
        ("sph", ctypes.c_void_p),
        ("tri", ctypes.c_void_p),
        ("mat", ctypes.c_void_p),
        ("light", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("nrays", ctypes.c_void_p),
        ("S", ctypes.c_int),
        ("T", ctypes.c_int),
        ("M", ctypes.c_int),
        ("L", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("seed", ctypes.c_int),
        ("spp_offset", ctypes.c_int),
        ("max_bounces", ctypes.c_int),
        ("rr_start", ctypes.c_int),
        ("use_nee", ctypes.c_int),
        ("uniform_lights", ctypes.c_int),
        ("ratio_x", ctypes.c_float),
        ("ratio_y", ctypes.c_float),
        ("t_min", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("cl", ClusterTables),
        ("inst", InstanceTables),
        ("state", ctypes.c_void_p),
        ("n_state", ctypes.c_int),
        ("bounce", ctypes.c_int),
        ("device", ctypes.c_int),
        ("env", ctypes.c_void_p),
        ("mat_w", ctypes.c_int),
        ("material", ctypes.c_int),
        ("metal", ctypes.c_int),
        ("aniso", ctypes.c_int),
        ("texture", ctypes.c_int),
        ("dispersion", ctypes.c_int),
        ("sky", ctypes.c_int),
        ("rough_diel", ctypes.c_int),
        ("env_map", ctypes.c_int),
        ("uv_space", ctypes.c_int),
        ("image", ctypes.c_int),
        ("tri_uv", ctypes.c_int),
        ("bilinear", ctypes.c_int),
        ("env_img", ctypes.c_void_p),
        ("env_smp", ctypes.c_void_p),
        ("env_pick", ctypes.c_void_p),
        ("env_k", ctypes.c_int),
        ("atlas", ctypes.c_void_p),
        ("atlas_k", ctypes.c_int),
        ("tri_uvs", ctypes.c_void_p),
        ("cl_uv", ctypes.c_void_p),
        ("tex", ctypes.c_int),
        ("normal_map", ctypes.c_int),
        ("n_mips", ctypes.c_int),
        ("tacc", ctypes.c_int),
        ("lod_alpha", ctypes.c_float),
        ("samp", ctypes.c_int),
        ("aperture", ctypes.c_float),
        ("focus_dist", ctypes.c_float),
        ("r2", ctypes.c_int),
        ("active", ctypes.c_void_p),
        ("cell_h", ctypes.c_int),
        ("cell_w", ctypes.c_int),
        ("grid_w", ctypes.c_int),
    ]


class AdaptArgs(ctypes.Structure):
    """Mirror of ``pt::AdaptArgs`` (csrc/pt.cuh), field for field."""

    _fields_ = [
        ("rad", ctypes.c_void_p),
        ("acc", ctypes.c_void_p),
        ("mean", ctypes.c_void_p),
        ("m2", ctypes.c_void_p),
        ("active", ctypes.c_void_p),
        ("taken", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("w", ctypes.c_int),
        ("cell_h", ctypes.c_int),
        ("cell_w", ctypes.c_int),
        ("grid_w", ctypes.c_int),
        ("n_cells", ctypes.c_int),
        ("half", ctypes.c_int),
        ("s", ctypes.c_int),
        ("min_spp", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("tol", ctypes.c_float),
        ("device", ctypes.c_int),
    ]


def pack_pt_scene(scene: PTScene):
    """The scene as kernel tables (ops/pallas/pt_kernel.py pack_pt_scene, the
    slice's columns): sph (S, 8) [pos, radius, mat, 0 x3]; tri (T, 12) [v0,
    e1, e2, mat, 0 x2]; mat (M, 8 to 20 + 4 L + 5) [albedo, emission, kind,
    ior], then the optional columns in JAX's fixed order
    (pt_kernel.py:59-81): albedo2 and the checker scale, tex_space,
    tex_rect, the L mip rects, nrm_rect and nrm_scale, rough, rough2,
    dispersion, zero-padded to a multiple of 4; light (L, 12) [kind, prim,
    area, le, pick, cdf, total_power, 0 x3]; counts int32 (4,) [spheres,
    triangles, materials, lights]; env (2, 4) [bottom, 0; top, 0] of the
    gradient sky, (0, 4) without one. The features' other tables:
    feature_tables."""
    f32 = torch.float32
    S, T = scene.sph_pos.shape[0], scene.tri_v0.shape[0]
    M, L = scene.mat_albedo.shape[0], scene.light_kind.shape[0]
    dev = scene.device
    sph = torch.cat([scene.sph_pos, scene.sph_radius[:, None],
                     scene.sph_mat[:, None].to(f32), torch.zeros((S, 3), dtype=f32, device=dev)], 1)
    tri = torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat[:, None].to(f32),
                     torch.zeros((T, 2), dtype=f32, device=dev)], 1)
    mat_cols = [scene.mat_albedo, scene.mat_emission, scene.mat_kind[:, None].to(f32),
                scene.mat_ior[:, None]]
    if scene.has_texture:
        mat_cols += [scene.mat_albedo2, scene.mat_tex_scale[:, None]]
    if scene.mat_tex_space is not None:
        mat_cols += [scene.mat_tex_space[:, None]]
    if scene.has_image:
        mat_cols += [scene.mat_tex_rect]
    if scene.has_mips:
        mat_cols += [scene.mat_tex_mips]
    if scene.has_normal_map:
        mat_cols += [scene.mat_nrm_rect, scene.mat_nrm_scale[:, None]]
    if scene.has_metal:
        mat_cols += [scene.mat_rough[:, None]]
    if scene.has_aniso:
        mat_cols += [scene.mat_rough2[:, None]]
    if scene.has_dispersion:
        mat_cols += [scene.mat_dispersion[:, None]]
    width = sum(c.shape[1] for c in mat_cols)
    if width % 4:
        mat_cols.append(torch.zeros((M, 4 - width % 4), dtype=f32, device=dev))
    mat = torch.cat(mat_cols, 1)
    light = torch.cat([scene.light_kind[:, None].to(f32), scene.light_prim[:, None].to(f32),
                       scene.light_area[:, None], scene.light_le, scene.light_pick[:, None],
                       scene.light_cdf[:, None], scene.light_total_power.expand(L, 1),
                       torch.zeros((L, 3), dtype=f32, device=dev)], 1)
    # torch.full, not torch.tensor: a host-to-device copy would block the
    # host until the stream drains, every call
    counts = torch.stack([scene.sph_count, scene.tri_count,
                          torch.full((), M, dtype=torch.int32, device=dev), scene.light_count])
    if scene.has_env:
        env = torch.cat([scene.env, torch.zeros((2, 1), dtype=f32, device=dev)], 1)
    else:
        env = torch.zeros((0, 4), dtype=f32, device=dev)
    return (sph.contiguous(), tri.contiguous(), mat.contiguous(), light.contiguous(), counts,
            env.contiguous())


def kernel_scene(scene: PTScene, bvh) -> PTScene:
    """With a ClusterSet or InstancedClusters the mesh lives in its tables:
    keep only the first TRI_UNROLL_MAX triangle slots (the NEE light
    geometry) of the scene, as the JAX megakernel does
    (pt_kernel.py:488-500)."""
    if bvh is None:
        return scene
    n = min(scene.tri_v0.shape[0], TRI_UNROLL_MAX)
    return dataclasses.replace(
        scene, tri_v0=scene.tri_v0[:n].contiguous(), tri_e1=scene.tri_e1[:n].contiguous(),
        tri_e2=scene.tri_e2[:n].contiguous(), tri_mat=scene.tri_mat[:n].contiguous(),
        tri_uv=None if scene.tri_uv is None else scene.tri_uv[:n].contiguous(),
        tri_count=torch.clamp_max(scene.tri_count, n))


def _prepare(cfg: PTConfig, scene: PTScene, row0: int, band_h, bvh, need_bvh=False):
    """The config the kernels render (rng forced to pcg, as the JAX
    wrappers do) and the band height, after the slice's checks."""
    if bvh is not None and not isinstance(bvh, (ClusterSet, InstancedClusters)):
        raise TypeError("the megakernels take a ClusterSet (accel.clusters.build_clusters) or "
                        "an InstancedClusters (accel.instancing.make_instanced_clusters), got "
                        f"{type(bvh).__name__}; for a skip-link BVH use render_pt_fast")
    if need_bvh and bvh is None:
        raise TypeError("render_pt_rebin needs a ClusterSet (accel.clusters.build_clusters) "
                        "or an InstancedClusters")
    if bvh is None and scene.tri_v0.shape[0] > TRI_UNROLL_MAX:
        raise ValueError(f"megakernel unrolls triangles; {scene.tri_v0.shape[0]} slots > "
                         f"{TRI_UNROLL_MAX}: pass bvh=build_clusters(mesh) instead")
    if cfg.rng != "pcg":
        cfg = dataclasses.replace(cfg, rng="pcg")
    check_supported(cfg)
    if cfg.tex_filter == "trilinear" and not scene.has_mips:
        raise ValueError("tex_filter='trilinear' needs packed mip chains — build the scene "
                         "with build_pt_scene(tex_mips=True)")
    h = band_h or cfg.height
    if not 0 <= row0 <= cfg.height - h:
        raise ValueError(f"band rows {row0}..{row0 + h} outside the {cfg.height}-row image")
    return cfg, h


def frame_view(bvh, cam_pos):
    """The in-kernel view of `bvh` for a frame seen from cam_pos (3,):
    FrameClusters of a ClusterSet, FrameInstances of an InstancedClusters,
    None without a mesh."""
    if bvh is None:
        return None
    if isinstance(bvh, InstancedClusters):
        return FrameInstances.at(bvh, cam_pos)
    return FrameClusters.at(bvh, cam_pos)


def mesh_kind(frame) -> str:
    """The name (MESH_KINDS) of K4's instantiation for a frame view
    (frame_view), which keys mesh_launches: "instances" for FrameInstances,
    "clusters" for FrameClusters, "none" for None. csrc/pt.cu pt_render
    picks the instantiation by the same rule from the tables that
    _kernel_args fills from the view (ClusterTables, InstanceTables)."""
    if frame is None:
        return "none"
    return "instances" if isinstance(frame, FrameInstances) else "clusters"


# --- adaptive spp (K4 feature 14) --------------------------------------------

def adaptive_grid(scene: PTScene, h: int, w: int, tile=(64, 256), stripes=None):
    """(grid_h, grid_w, cell_h, cell_w): the cells whose pixels stop taking
    passes together, JAX's grid cells (ops/pallas/pt_kernel.py:464-480): the
    tile's width narrowed to the atlas' or the env map's row width where the
    scene has one, pick_tile(h, w, *tile), then `stripes` halved until it
    fits; cell (i, j) covers rows i cell_h .. and columns j cell_w ..,
    cell_h = tile_h stripes and cell_w = tile_w / stripes."""
    if scene.has_atlas and tile[1] != scene.tex_atlas.shape[1]:
        tile = (tile[0], scene.tex_atlas.shape[1])
    if scene.has_env_map and tile[1] != scene.env_img.shape[1]:
        tile = (tile[0], scene.env_img.shape[1])
    th, tw = common.pick_tile(h, w, *tile)
    stripes = 1 if stripes is None else stripes
    while stripes > 1 and not (tw % stripes == 0 and h % (th * stripes) == 0
                               and w % (tw // stripes) == 0):
        stripes //= 2
    ch, cw = th * stripes, tw // stripes
    return h // ch, w // cw, ch, cw


def _half(grid) -> int:
    """Half the cell's pixel count rounded up to a power of 2 (0: one pixel)."""
    return (1 << (grid[2] * grid[3] - 1).bit_length()) // 2


def cell_sums(v, grid):
    """(grid_h, grid_w) sums of the (h, w) plane v over each cell, in the
    order of pt_cell_kernel: the cell's pixels row-major, zero-padded to a
    power of 2, element i added to element i + half at each level."""
    gh, gw, ch, cw = grid
    x = v.reshape(gh, ch, gw, cw).permute(0, 2, 1, 3).reshape(gh, gw, ch * cw)
    half = _half(grid)
    if 2 * half > ch * cw:
        x = torch.cat([x, x.new_zeros((gh, gw, 2 * half - ch * cw))], -1)
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


@dataclasses.dataclass
class AdaptState:
    """The planes and tables of an adaptive render (K4 feature 14): the sum
    of the passes taken, each pixel's Welford mean and M2 of its luminance,
    each cell's flag (1 while it takes passes) and passes taken, and the
    image, written cell by cell as they stop (NaN, JAX's 0 * (1 / 0), in a
    cell that takes none)."""

    acc: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    active: torch.Tensor
    taken: torch.Tensor
    out: torch.Tensor
    grid: tuple

    @classmethod
    def start(cls, h: int, w: int, grid, min_spp: int, device):
        f32 = torch.float32
        n = grid[0] * grid[1]
        return cls(acc=torch.zeros((h, w, 3), dtype=f32, device=device),
                   mean=torch.zeros((h, w), dtype=f32, device=device),
                   m2=torch.zeros((h, w), dtype=f32, device=device),
                   active=torch.full((n,), int(min_spp > 0), dtype=torch.int32, device=device),
                   taken=torch.zeros((n,), dtype=f32, device=device),
                   out=torch.full((h, w, 3), float("nan"), dtype=f32, device=device),
                   grid=tuple(grid))

    def pixels(self, cells):
        """(h, w): each pixel's entry of the (n_cells,) per-cell `cells` (a
        bool: the pixels of the cells where it holds)."""
        gh, gw, ch, cw = self.grid
        return cells.reshape(gh, 1, gw, 1).expand(gh, ch, gw, cw).reshape(gh * ch, gw * cw)

    def pixel_active(self):
        """(h, w) bool: the pixels whose cell takes passes."""
        return self.pixels(self.active != 0)


def cell_rel(st: AdaptState, s: int):
    """(grid_h, grid_w) float32: each cell's relative standard error after s
    passes, mean(se) / max(mean(mean), 1e-4), se a pixel's sqrt(max(M2 /
    max(s - 1, 1) / max(s, 1), 0)) rooted in float64 (PyTorch's float32
    root on the CPU is not correctly rounded), the means cell_sums over the
    cell's pixel count."""
    dev = st.m2.device
    sf = torch.full((), float(s), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    var = st.m2 / torch.maximum(sf - 1.0, one)
    se_px = torch.sqrt(torch.clamp_min(var / torch.maximum(sf, one), 0.0).double()).float()
    n = torch.full((), float(st.grid[2] * st.grid[3]), dtype=torch.float32, device=dev)
    se = cell_sums(se_px, st.grid) / n
    return se / torch.clamp_min(cell_sums(st.mean, st.grid) / n, 1e-4)


def adapt_pass_reference(rad, st: AdaptState, s: int, min_spp: int, spp: int, tol: float):
    """Plain PyTorch version of pt_cell_kernel, in place on st: after the
    pass that brings the active cells to s passes (rad (h, w, 3) its
    radiance), each of their pixels adds it to acc and updates its Welford
    mean and M2 (ops/pallas/pt_kernel.py:343-351); each such cell records s
    passes and takes another while s < min_spp, or while s < spp and its
    cell_rel exceeds tol (:330-339); else it writes acc * (1 / s)
    (:357-363)."""
    dev = rad.device
    sf = torch.full((), float(s), dtype=torch.float32, device=dev)
    px = st.pixel_active()
    acc = st.acc + rad
    x = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2]
    d = x - st.mean
    mean = st.mean + d / sf
    m2 = st.m2 + d * (x - mean)
    st.acc.copy_(torch.where(px[..., None], acc, st.acc))
    st.mean.copy_(torch.where(px, mean, st.mean))
    st.m2.copy_(torch.where(px, m2, st.m2))
    rel = cell_rel(st, s)
    tol32 = torch.full((), tol, dtype=torch.float32, device=dev)
    more = (rel > tol32) if s < spp else torch.zeros_like(rel, dtype=torch.bool)
    if s < min_spp:
        more = torch.ones_like(more)
    active = st.active.reshape(rel.shape) != 0
    stop = (active & ~more).reshape(-1)
    st.taken.copy_(torch.where(st.active != 0, sf, st.taken))
    stop_px = st.pixels(stop)
    inv = torch.ones((), dtype=torch.float32, device=dev) / sf
    st.out.copy_(torch.where(stop_px[..., None], st.acc * inv, st.out))
    st.active.copy_((active & more).reshape(-1).to(torch.int32))


def adapt_pass(rad, st: AdaptState, s: int, min_spp: int, spp: int, tol: float):
    """The cell update after an adaptive pass: pt_cell_kernel on CUDA
    tensors, adapt_pass_reference on CPU ones."""
    global adapt_launches
    if rad.device.type == "cpu":
        return adapt_pass_reference(rad, st, s, min_spp, spp, tol)
    h, w = st.mean.shape
    dev = rad.device
    for name, t, shape, dtype in (("rad", rad, (h, w, 3), torch.float32),
                                  ("acc", st.acc, (h, w, 3), torch.float32),
                                  ("mean", st.mean, (h, w), torch.float32),
                                  ("m2", st.m2, (h, w), torch.float32),
                                  ("out", st.out, (h, w, 3), torch.float32),
                                  ("active", st.active, st.active.shape, torch.int32),
                                  ("taken", st.taken, st.active.shape, torch.float32)):
        common.check(t, name, shape, dtype, dev)
    gh, gw, ch, cw = st.grid
    half = _half(st.grid)
    scratch = torch.empty((gh * gw, 2, max(half, 1)), dtype=torch.float32, device=dev)
    args = AdaptArgs(
        rad=rad.data_ptr(), acc=st.acc.data_ptr(), mean=st.mean.data_ptr(), m2=st.m2.data_ptr(),
        active=st.active.data_ptr(), taken=st.taken.data_ptr(), out=st.out.data_ptr(),
        scratch=scratch.data_ptr(), w=w, cell_h=ch, cell_w=cw, grid_w=gw, n_cells=gh * gw,
        half=half, s=s, min_spp=min_spp, spp=spp, tol=tol,
        device=dev.index if dev.index is not None else torch.cuda.current_device())
    common.launch("pt_adapt", args, name="pt")
    adapt_launches += 1
    del scratch


def render_pt_mega_reference(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int, *,
                             seed: int = 0, spp_offset: int = 0, bvh=None, row0: int = 0,
                             band_h=None, adaptive_tol=0.0, adaptive_min=8, tile=(64, 256),
                             stripes=None):
    """Plain PyTorch version: the wavefront core per pass (the attributes
    path with the camera's visit orders for a ClusterSet or an
    InstancedClusters), passes summed in pass order and then scaled by
    1/spp (ops/pallas/pt_kernel.py:360-363); pass s keyed on the global pass
    spp_offset + s and the base seed, which the R_d sampler reads.
    → ((band_h or H, W, 3) image, nrays int64). With adaptive_tol > 0, each
    pass traces the pixels of the cells still taking passes
    (adaptive_grid(scene, h, W, tile, stripes)) and adapt_pass_reference
    updates the cells: → (image, nrays, (grid_h, grid_w) float32 passes
    taken)."""
    cfg, h = _prepare(cfg, scene, row0, band_h, bvh)
    scene_k = kernel_scene(scene, bvh)
    frame = frame_view(bvh, cam_pos)
    dev = scene.device
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    if adaptive_tol > 0.0:
        min_spp = min(adaptive_min, spp)
        st = AdaptState.start(h, cfg.width, adaptive_grid(scene, h, cfg.width, tile, stripes),
                              min_spp, dev)
        py = torch.arange(h, device=dev)[:, None].expand(h, cfg.width) + row0
        px = torch.arange(cfg.width, device=dev).expand(h, cfg.width)
        for s in range(spp):
            sel = st.pixel_active()
            if not bool(sel.any()):
                break
            g = spp_offset + s
            rad, n = _trace_core(cfg, scene_k, cam_pos, cam_quat, pass_seed(seed, g),
                                 pix=(py[sel], px[sel]), bvh=frame, gpass=g, seed_base=seed)
            full = torch.zeros((h, cfg.width, 3), dtype=torch.float32, device=dev)
            full[sel] = torch.stack(rad, dim=-1)
            adapt_pass_reference(full, st, s + 1, min_spp, spp, float(adaptive_tol))
            nrays = nrays + n
        return st.out, nrays, st.taken.reshape(st.grid[:2])
    acc = torch.zeros((h, cfg.width, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        g = spp_offset + s
        rad, n = _trace_core(cfg, scene_k, cam_pos, cam_quat, pass_seed(seed, g),
                             row0=row0, band_h=h, bvh=frame, gpass=g, seed_base=seed)
        acc = acc + torch.stack(rad, dim=-1)
        nrays = nrays + n
    inv = float(np.float32(1.0) / np.float32(spp))
    return acc * inv, nrays


def feature_tables(scene: PTScene):
    """The tables of the features the kernels read from global memory, each
    None where the scene lacks it: env_img and env_smp (3K, 128) and
    env_pick (1,) of the env map, the atlas (3K, 128), and the unrolled
    slots' UVs (T, 8) [u0, v0, u1, v1, u2, v2, 0, 0]."""
    f32 = torch.float32
    tri_uvs = None
    if scene.has_tri_uv:
        T = scene.tri_uv.shape[0]
        tri_uvs = torch.cat([scene.tri_uv, torch.zeros((T, 2), dtype=f32, device=scene.device)],
                            1).contiguous()
    env = (None,) * 3
    if scene.has_env_map:
        env = (scene.env_img.contiguous(), scene.env_smp.contiguous(),
               scene.env_pick.reshape(1).contiguous())
    return dict(env_img=env[0], env_smp=env[1], env_pick=env[2],
                atlas=None if scene.tex_atlas is None else scene.tex_atlas.contiguous(),
                tri_uvs=tri_uvs)


def uses_tex_instantiation(scene: PTScene, bvh) -> bool:
    """Whether K4 and K5 launch their texture instantiation: the scene's
    shading reads the texture-u tangent (normal maps, mips), or it reads hit
    UVs off a UV ClusterSet under instances (bvh an InstancedClusters or its
    frame view)."""
    ic = bvh.ic if isinstance(bvh, FrameInstances) else bvh
    return scene.needs_tan or (isinstance(ic, InstancedClusters) and ic.cs.has_uv
                               and scene.needs_uv)


def _kernel_args(cfg: PTConfig, scene_k: PTScene, cam_pos, cam_quat, h: int, row0: int,
                 seed: int, spp_offset: int, frame):
    """(PTArgs without out / nrays / state, the tensors it points into)."""
    f32 = torch.float32
    device = scene_k.device
    if device.type != "cuda":
        raise ValueError(f"scene on {device}: the CUDA kernels need a CUDA device")
    common.check(cam_pos, "cam_pos", (3,), f32, device)
    common.check(cam_quat, "cam_quat", (4,), f32, device)
    tables = pack_pt_scene(scene_k)
    sph, tri, mat, light, counts, env = tables
    table_bytes = 4 * (sph.numel() + tri.numel() + mat.numel() + light.numel() + env.numel())
    if table_bytes > _MAX_TABLE_BYTES:
        raise ValueError(f"scene tables of {table_bytes} B exceed the kernel's "
                         f"{_MAX_TABLE_BYTES} B of shared memory")
    feats = feature_tables(scene_k)
    keep = list(tables) + [t for t in feats.values() if t is not None]
    cl, inst = ClusterTables(), InstanceTables()
    cl_uv = None
    if isinstance(frame, FrameInstances):
        cs = frame.ic.cs
        if cs.device != device:
            raise ValueError(f"InstancedClusters on {cs.device}, scene on {device}")
        tb = kcluster.sweep_tables(cs)
        order = torch.arange(cs.num_super, dtype=torch.int32, device=device)
        cl = kcluster.tables_struct(tb, order)
        inst = kinst.instance_struct(frame.ic.inst_tab, cs, frame.iorder, frame.iorders)
        cl_uv = tb.tuv
        keep += [tb, order, frame]
    elif frame is not None:
        if frame.cs.device != device:
            raise ValueError(f"ClusterSet on {frame.cs.device}, scene on {device}")
        tb = kcluster.sweep_tables(frame.cs)
        order, orders, refs = kcluster.check_orders(frame.cs, frame.orders[0], frame.orders,
                                                    frame.refs)
        cl = kcluster.tables_struct(tb, order, orders, refs)
        cl_uv = tb.tuv
        keep += [tb, order, orders, refs]
    args = PTArgs(
        cam_pos=cam_pos.data_ptr(), cam_quat=cam_quat.data_ptr(),
        sph=sph.data_ptr(), tri=tri.data_ptr(), mat=mat.data_ptr(), light=light.data_ptr(),
        counts=counts.data_ptr(),
        S=sph.shape[0], T=tri.shape[0], M=mat.shape[0], L=light.shape[0],
        width=cfg.width, height=cfg.height, w=cfg.width, h=h, row0=row0,
        seed=to_int32(seed), spp_offset=to_int32(spp_offset),
        max_bounces=cfg.max_bounces, rr_start=cfg.rr_start, use_nee=int(cfg.use_nee),
        uniform_lights=int(cfg.light_sampling == "uniform"),
        ratio_x=cfg.ratio[0], ratio_y=cfg.ratio[1], t_min=cfg.t_min, eps=cfg.eps, cl=cl,
        inst=inst,
        device=device.index if device.index is not None else torch.cuda.current_device(),
        env=env.data_ptr() if scene_k.has_env else None, mat_w=mat.shape[1],
        material=int(scene_k.has_material_features),
        metal=int(scene_k.has_metal), aniso=int(scene_k.has_aniso),
        texture=int(scene_k.has_texture), dispersion=int(scene_k.has_dispersion),
        sky=int(scene_k.has_env),
        rough_diel=int(scene_k.has_rough_dielectric), env_map=int(scene_k.has_env_map),
        uv_space=int(scene_k.mat_tex_space is not None), image=int(scene_k.has_image),
        tri_uv=int(scene_k.has_tri_uv),
        # normal maps stay bilinear under the trilinear albedo filter
        bilinear=int(cfg.tex_filter in ("bilinear", "trilinear")),
        env_k=0 if feats["env_img"] is None else feats["env_img"].shape[0] // 3,
        atlas_k=0 if feats["atlas"] is None else feats["atlas"].shape[0] // 3,
        cl_uv=None if cl_uv is None else cl_uv.data_ptr(),
        **{k: None if t is None else t.data_ptr() for k, t in feats.items()},
        tex=int(uses_tex_instantiation(scene_k, frame)),
        normal_map=int(scene_k.has_normal_map), n_mips=scene_k.n_mip_levels,
        tacc=int(has_tacc(scene_k, cfg)), lod_alpha=2.0 * cfg.fov / cfg.width,
        samp=int(cfg.aperture > 0.0 or cfg.sampler == "r2"),
        aperture=max(cfg.aperture, 0.0), focus_dist=cfg.focus_dist,
        r2=int(cfg.sampler == "r2"),
    )
    return args, keep


def render_pt_mega(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                   key=None, spp_offset: int = 0, interpret=None, tile=(64, 256), bvh=None,
                   row0: int = 0, band_h=None, stripes=None, groups=1, fast_math=False,
                   adaptive_tol=0.0, adaptive_min=8, return_spp=False, *, seed=None):
    """Megakernel render: ((band_h or H, W, 3) image, nrays int64 0-dim).
    JAX's signature (ops/pallas/pt_kernel.py render_pt_mega), position for
    position; seed, the port's own, is keyword-only.

    The pcg stream, whatever cfg.rng says, as in the JAX package. key: the
    PRNG key (ops/rng.py key_words), or seed: the int32 base seed in its
    place (ops.rng_pcg.seed_from_int(1) matches jax.random.PRNGKey(1)), not
    both; default PRNGKey(0). Pass s uses the global pass
    index spp_offset + s. row0/band_h: render only rows row0 .. row0 + band_h - 1
    of the cfg.height image; a band equals the same rows of the full render,
    since the camera and the stream are keyed on global pixel coordinates.
    bvh: a ClusterSet for a mesh of any size (its closest and shadow sweeps
    run in the kernel, the warp's lanes together), or an InstancedClusters
    (K7's two-level sweep in the kernel, materials per instance); without
    one, at most
    TRI_UNROLL_MAX triangle slots. A raw BVH raises TypeError, as in the
    JAX package: it goes to render_pt_fast.

    interpret, groups and fast_math are TPU knobs, accepted and ignored.

    Adaptive spp (adaptive_tol > 0): the image's cells (adaptive_grid: JAX's
    grid cells from tile and stripes, which mean only this here) take
    passes independently: each pixel's luminance is tracked across passes,
    and a cell stops once it has taken min(adaptive_min, spp) passes and the
    relative standard error of its pixels' means is at most adaptive_tol,
    or at spp; a pixel is the mean of its cell's passes, and nrays counts
    the passes taken. return_spp=True appends the (grid_h, grid_w) float32
    table of the passes each cell took (all spp without adaptive_tol).
    """
    global launches, sampling_launches
    del interpret, groups, fast_math
    seed = pcg_base_seed(seed, key)
    h = band_h or cfg.height
    grid = adaptive_grid(scene, h, cfg.width, tile, stripes)
    adaptive = adaptive_tol > 0.0
    if scene.device.type == "cpu":
        res = render_pt_mega_reference(cfg, scene, cam_pos, cam_quat, spp, seed=seed,
                                       spp_offset=spp_offset, bvh=bvh, row0=row0,
                                       band_h=band_h, adaptive_tol=adaptive_tol,
                                       adaptive_min=adaptive_min, tile=tile, stripes=stripes)
    else:
        cfg, h = _prepare(cfg, scene, row0, band_h, bvh)
        if spp < 1:
            raise ValueError(f"spp must be >= 1, got {spp}")
        frame = frame_view(bvh, cam_pos)
        args, keep = _kernel_args(cfg, kernel_scene(scene, bvh), cam_pos, cam_quat, h, row0,
                                  seed, spp_offset, frame)
        nrays = torch.zeros((1,), dtype=torch.int64, device=scene.device)
        args.nrays = nrays.data_ptr()
        kind = mesh_kind(frame)
        if adaptive:
            min_spp = min(adaptive_min, spp)
            st = AdaptState.start(h, cfg.width, grid, min_spp, scene.device)
            rad = torch.empty((h, cfg.width, 3), dtype=torch.float32, device=scene.device)
            args.out, args.spp, args.active = rad.data_ptr(), 1, st.active.data_ptr()
            args.samp = 1
            args.cell_h, args.cell_w, args.grid_w = grid[2], grid[3], grid[1]
        else:
            out = torch.empty((h, cfg.width, 3), dtype=torch.float32, device=scene.device)
            args.out, args.spp = out.data_ptr(), spp
        for k in range(spp if adaptive else 1):
            if adaptive:
                args.spp_offset = to_int32(spp_offset + k)
            common.launch("pt_render", args, name="pt")
            launches += 1
            mesh_launches[kind] += 1
            material_launches[kind] += args.material
            tex_launches[kind] += args.tex
            sampling_launches += args.samp
            if adaptive:
                adapt_pass(rad, st, k + 1, min_spp, spp, float(adaptive_tol))
        del keep
        res = ((st.out, nrays[0], st.taken.reshape(grid[:2])) if adaptive
               else (out, nrays[0]))
    if not return_spp:
        return res[:2]
    if adaptive:
        return res
    return (*res, torch.full(grid[:2], float(spp), dtype=torch.float32, device=scene.device))


# --- the rebin renderer (K5) --------------------------------------------------

def rebin_keys(state, mode: str, lo=None, hi=None, tile_ids=None):
    """int32 regroup sort key per ray of a (17 to 19, n) packed state
    (pt_kernel.py:847-892). Every mode puts parked/dead rays (|o.x| >= 1e17)
    last; the live sub-order:

      oct         direction octant, then the incoming order (stable sort)
      morton      24-bit origin Morton code in the box (lo, hi), then octant
      oct_morton  octant major, origin Morton minor
      tile_oct    current tile id major (tile_ids), octant minor; parked
                  rays carry octant 7 and sink to each tile's tail
    """
    ox, oy, oz = state[0], state[1], state[2]
    dx, dy, dz = state[3], state[4], state[5]
    i32 = torch.int32
    dead = (torch.abs(ox) >= kcluster.PARKED).to(i32)
    octant = (dx > 0.0).to(i32) * 4 + (dy > 0.0).to(i32) * 2 + (dz > 0.0).to(i32)
    if mode == "oct":
        return dead * 8 + octant
    if mode == "tile_oct":
        return tile_ids.to(i32) * 8 + octant

    def q(x, a, b):
        c = (x - a) / torch.clamp_min(b - a, 1e-6) * 256.0
        return torch.nan_to_num(c, nan=0.0).clamp(0.0, 255.0).to(i32)

    qx, qy, qz = q(ox, lo[0], hi[0]), q(oy, lo[1], hi[1]), q(oz, lo[2], hi[2])
    m = torch.zeros_like(qx)
    for bit in range(8):
        m = (m | (((qx >> bit) & 1) << (3 * bit + 2))
             | (((qy >> bit) & 1) << (3 * bit + 1))
             | (((qz >> bit) & 1) << (3 * bit)))
    if mode == "morton":
        return dead * (1 << 27) + m * 8 + octant
    if mode == "oct_morton":
        return dead * (1 << 27) + octant * (1 << 24) + m
    raise ValueError(f"rebin mode {mode!r}")


def live_bbox(state):
    """AABB of the live ray origins of a packed state, the Morton domain:
    (lo, hi), each a 3-tuple of 0-dim tensors on the state's device (no host
    read). Perf hint only: any box yields the same image."""
    live = torch.abs(state[0]) < kcluster.PARKED
    lo = tuple(torch.where(live, state[a], float("inf")).amin() for a in range(3))
    hi = tuple(torch.where(live, state[a], float("-inf")).amax() for a in range(3))
    return lo, hi


_MODES = ("none", "oct", "morton", "oct_morton", "tile_oct")


def _gap_modes(rebin: str):
    modes = rebin.split(",")
    for m in modes:
        if m not in _MODES:
            raise ValueError(f"rebin mode {m!r}: one of {_MODES}")
    return modes


def regroup(state, mode: str):
    """The image-wide regroup before a bounce launch: a stable sort of the
    keys, then every plane permuted (a new tensor). mode 'none' keeps the
    order."""
    if mode == "none":
        return state
    lo = hi = tids = None
    if mode in ("morton", "oct_morton"):
        lo, hi = live_bbox(state)
    if mode == "tile_oct":
        tids = torch.arange(state.shape[1], device=state.device) // REBIN_TILE
    keys = rebin_keys(state, mode, lo, hi, tids)
    perm = torch.sort(keys, stable=True).indices
    return state.index_select(1, perm)


def unpermute(state, row0: int, h: int, w: int):
    """The radiance planes of a state back in pixel order: (h, w, 3), one
    scatter on the carried pixel ids ((py - row0) * w + px)."""
    pixid = (state[16].to(torch.int64) - row0) * w + state[15].to(torch.int64)
    img = torch.empty((h * w, 3), dtype=torch.float32, device=state.device)
    img.index_copy_(0, pixid, state[9:12].T)
    return img.reshape(h, w, 3)


def _rebin(cfg: PTConfig, scene: PTScene, spp: int, spp_offset: int, row0: int, h: int,
           rebin: str, run_bounce):
    """The rebin loop shared by the kernel and its plain version:
    run_bounce(b, state, gpass) -> (state, nrays) runs bounce b."""
    modes = _gap_modes(rebin)
    dev = scene.device
    acc = torch.zeros((h, cfg.width, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        gpass = spp_offset + s
        state, nr = run_bounce(0, None, gpass)
        nrays = nrays + nr
        for b in range(1, cfg.max_bounces + 1):
            state = regroup(state, modes[min(b - 1, len(modes) - 1)])
            state, nr = run_bounce(b, state, gpass)
            nrays = nrays + nr
        acc = acc + unpermute(state, row0, h, cfg.width)
    # true division by a device scalar, as JAX's acc / spp (ops/vec3.div)
    return acc / torch.full((), float(spp), dtype=torch.float32, device=dev), nrays


def render_pt_rebin_reference(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int, *,
                              seed: int = 0, bvh=None, spp_offset: int = 0, row0: int = 0,
                              band_h=None, rebin: str = "none,morton"):
    """Plain PyTorch version of render_pt_rebin: the staged wavefront core
    (attributes path, the camera's visit orders) per bounce, the same
    regroup and scatter."""
    cfg, h = _prepare(cfg, scene, row0, band_h, bvh, need_bvh=True)
    scene_k = kernel_scene(scene, bvh)
    frame = frame_view(bvh, cam_pos)
    n = h * cfg.width
    planes = state_plane_count(scene, cfg)

    def run_bounce(b, state, gpass):
        kw = dict(bvh=frame, bounce_lo=b, bounce_hi=b, emit_state=True)
        seed0 = pass_seed(seed, gpass)
        if b == 0:
            st = _trace_core(cfg, scene_k, cam_pos, cam_quat, seed0, row0=row0, band_h=h,
                             gpass=gpass, seed_base=seed, **kw)
        else:
            st = _trace_core(cfg, scene_k, cam_pos, cam_quat, seed0,
                             state_in=unpack_state(state, has_chan=scene.has_dispersion,
                                                   has_tacc=has_tacc(scene, cfg)),
                             gpass=gpass, seed_base=seed, **kw)
        return pack_state(st).reshape(planes, n), st["nrays"]

    return _rebin(cfg, scene, spp, spp_offset, row0, h, rebin, run_bounce)


def rebin_bounce_launcher(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, seed: int,
                          bvh, row0: int = 0, band_h=None):
    """(cfg, band height, run_bounce): run_bounce(b, state, gpass) launches
    K5 for bounce b of global pass gpass on the (17 to 19, n) state
    (state_plane_count; None for b = 0: a new one), updates it in place and
    returns (state, nrays).
    Arguments after the checks of render_pt_rebin; the tables are packed
    once here."""
    cfg, h = _prepare(cfg, scene, row0, band_h, bvh, need_bvh=True)
    dev = scene.device
    args, keep = _kernel_args(cfg, kernel_scene(scene, bvh), cam_pos, cam_quat, h, row0,
                              seed, 0, frame_view(bvh, cam_pos))
    n = h * cfg.width
    args.n_state, args.spp = n, 1
    planes = state_plane_count(scene, cfg)

    def run_bounce(b, state, gpass):
        global rebin_launches, rebin_material_launches, rebin_tex_launches
        global rebin_sampling_launches
        if state is None:
            state = torch.empty((planes, n), dtype=torch.float32, device=dev)
        common.check(state, "state", (planes, n), torch.float32, dev)
        nr = torch.zeros((1,), dtype=torch.int64, device=dev)
        args.state, args.nrays, args.bounce = state.data_ptr(), nr.data_ptr(), b
        args.spp_offset = to_int32(gpass)
        common.launch("pt_rebin", args, name="pt")
        rebin_launches += 1
        rebin_material_launches += args.material
        rebin_tex_launches += args.tex
        rebin_sampling_launches += args.samp
        return state, nr[0]

    run_bounce.keep = keep  # the packed tables live as long as the launcher
    return cfg, h, run_bounce


def render_pt_rebin(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                    key=None, bvh=None, spp_offset: int = 0, interpret=None, tile=(32, 128),
                    tile_b=None, row0: int = 0, band_h=None, stripes=None,
                    rebin: str = "none,morton", fast_math=False, skip_dead=True, *, seed=None):
    """Rebin render: ((band_h or H, W, 3) image, nrays int64 0-dim), the
    estimator of render_pt_mega executed as one K5 launch per bounce with an
    image-wide regroup between launches. JAX's signature
    (ops/pallas/pt_kernel.py render_pt_rebin), position for position; seed,
    the port's own, is keyword-only. bvh: a ClusterSet or an
    InstancedClusters (required).

    rebin: the regroup key per gap, comma-joined; the last entry repeats for
    deeper bounces (modes: "none" keeps the order, else rebin_keys). The
    default "none,morton" keeps pixel order into bounce 1 and regroups by
    origin Morton cell before bounce 2+, so dead rays gather at the end.
    Each launch updates the state in place; each regroup makes a new one.
    seed or key: as render_pt_mega's. tile, tile_b, stripes, interpret,
    fast_math and skip_dead are TPU knobs, accepted and ignored.
    """
    del tile, tile_b, stripes, interpret, fast_math, skip_dead
    seed = pcg_base_seed(seed, key)
    if scene.device.type == "cpu":
        return render_pt_rebin_reference(cfg, scene, cam_pos, cam_quat, spp, seed=seed, bvh=bvh,
                                         spp_offset=spp_offset, row0=row0, band_h=band_h,
                                         rebin=rebin)
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    cfg, h, run_bounce = rebin_bounce_launcher(cfg, scene, cam_pos, cam_quat, seed, bvh,
                                               row0, band_h)
    return _rebin(cfg, scene, spp, spp_offset, row0, h, rebin, run_bounce)
