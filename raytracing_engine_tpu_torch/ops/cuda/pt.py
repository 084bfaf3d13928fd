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


def render_pt_mega_reference(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int, *,
                             seed: int = 0, spp_offset: int = 0, bvh=None, row0: int = 0,
                             band_h=None):
    """Plain PyTorch version: the wavefront core per pass (the attributes
    path with the camera's visit orders for a ClusterSet or an
    InstancedClusters), passes summed in pass order and then scaled by
    1/spp (ops/pallas/pt_kernel.py:360-363).
    → ((band_h or H, W, 3) image, nrays int64)."""
    cfg, h = _prepare(cfg, scene, row0, band_h, bvh)
    scene_k = kernel_scene(scene, bvh)
    frame = frame_view(bvh, cam_pos)
    acc = torch.zeros((h, cfg.width, 3), dtype=torch.float32, device=scene.device)
    nrays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(spp):
        rad, n = _trace_core(cfg, scene_k, cam_pos, cam_quat, pass_seed(seed, spp_offset + s),
                             row0=row0, band_h=h, bvh=frame)
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

    interpret, tile, stripes, groups and fast_math are TPU knobs, accepted
    and ignored. Adaptive spp (adaptive_tol > 0, return_spp) is not ported
    yet and raises.
    """
    global launches
    del interpret, tile, stripes, groups, fast_math, adaptive_min
    if adaptive_tol > 0.0 or return_spp:
        raise NotImplementedError("adaptive spp (adaptive_tol, adaptive_min, return_spp) is not "
                                  "ported yet (ROADMAP.md queue 1 item 4, K4 feature 14)")
    seed = pcg_base_seed(seed, key)
    if scene.device.type == "cpu":
        return render_pt_mega_reference(cfg, scene, cam_pos, cam_quat, spp, seed=seed,
                                         spp_offset=spp_offset, bvh=bvh, row0=row0,
                                         band_h=band_h)
    cfg, h = _prepare(cfg, scene, row0, band_h, bvh)
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    frame = frame_view(bvh, cam_pos)
    args, keep = _kernel_args(cfg, kernel_scene(scene, bvh), cam_pos, cam_quat, h, row0,
                              seed, spp_offset, frame)
    out = torch.empty((h, cfg.width, 3), dtype=torch.float32, device=scene.device)
    nrays = torch.zeros((1,), dtype=torch.int64, device=scene.device)
    args.out, args.nrays, args.spp = out.data_ptr(), nrays.data_ptr(), spp
    common.launch("pt_render", args, name="pt")
    launches += 1
    mesh_launches[mesh_kind(frame)] += 1
    material_launches[mesh_kind(frame)] += args.material
    tex_launches[mesh_kind(frame)] += args.tex
    del keep
    return out, nrays[0]


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
            st = _trace_core(cfg, scene_k, cam_pos, cam_quat, seed0, row0=row0, band_h=h, **kw)
        else:
            st = _trace_core(cfg, scene_k, cam_pos, cam_quat, seed0,
                             state_in=unpack_state(state, has_chan=scene.has_dispersion,
                                                   has_tacc=has_tacc(scene, cfg)), **kw)
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
