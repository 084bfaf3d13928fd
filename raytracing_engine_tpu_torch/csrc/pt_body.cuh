// The bodies of K4 and K5 and what they share, for their instantiations in
// pt.cu (the forms without the light features) and pt_lights.cu (the light
// forms, kLights): the block shapes, the staging of the scene tables in
// shared memory, the exact ray count, and pt_body / pt_rebin_body, each a
// template on the instantiation's flags (pt.cuh kMesh*, kMat, kTex, kSamp,
// kLights). Two sources, so that nvcc builds the two libraries at once.
#pragma once

#include "pt.cuh"

namespace pt {

// K4's block at each mesh kind, and whether its lanes sweep together (with
// a mesh). Measured on copies of the tree (PERF.md §6, ab_config3.py
// --worker): the warp form 2.6x the per-thread one at configs 3 and 5;
// with instances 8 x 16 (a warp 8 x 4 pixels) 3-5% faster than 32 x 4 and
// 16 x 8; with clusters 16 x 8 and 32 x 4 within 1%, 8 x 16 4-7% slower.
template <int kMesh>
struct K4 {
  static constexpr int kThreads = 128;
  static constexpr int kBlockX = kMesh == kMeshInstances ? 8 : 16;
  static constexpr int kBlockY = kThreads / kBlockX;
  static constexpr bool kWarp = kMesh != kMeshNone;
};
constexpr int kRebinThreads = 256;  // K5's block

// Stage the scene tables in shared memory (call from every thread, then
// __syncthreads) and describe them; the live counts come from a.counts.
// kMat: the material table a.mat_w wide and the sky's table after the
// lights, and the features' flags and column offsets; kTex: the texture
// features' too.
template <int kBlock, bool kMat, bool kTex = false>
__device__ __forceinline__ Scene stage_scene(const Args& a, float* tables, int tid) {
  const int mat_w = kMat ? a.mat_w : kMatW;
  const int n_sph_f = a.S * kSphW, n_tri_f = a.T * kTriW;
  const int n_mat_f = a.M * mat_w, n_light_f = a.L * kLightW;
  const int n_env_f = kMat && a.sky ? kEnvW : 0;
  float* s_sph = tables;
  float* s_tri = s_sph + n_sph_f;
  float* s_mat = s_tri + n_tri_f;
  float* s_light = s_mat + n_mat_f;
  float* s_env = s_light + n_light_f;
  for (int i = tid; i < n_sph_f; i += kBlock) s_sph[i] = __ldg(a.sph + i);
  for (int i = tid; i < n_tri_f; i += kBlock) s_tri[i] = __ldg(a.tri + i);
  for (int i = tid; i < n_mat_f; i += kBlock) s_mat[i] = __ldg(a.mat + i);
  for (int i = tid; i < n_light_f; i += kBlock) s_light[i] = __ldg(a.light + i);
  // (a loop over nothing is not dropped: the compiler cannot tell tid >= 0)
  if constexpr (kMat) {
    for (int i = tid; i < n_env_f; i += kBlock) s_env[i] = __ldg(a.env + i);
  }
  Scene sc;
  sc.sph = s_sph;
  sc.tri = s_tri;
  sc.mat = s_mat;
  sc.light = s_light;
  sc.env = s_env;
  sc.mat_w = mat_w;
  sc.metal = kMat && a.metal;
  sc.aniso = kMat && a.aniso;
  sc.texture = kMat && a.texture;
  sc.dispersion = kMat && a.dispersion;
  sc.sky = kMat && a.sky;
  sc.rough_diel = kMat && a.rough_diel;
  sc.env_map = kMat && a.env_map;
  sc.uv_space = kMat && a.uv_space;
  sc.image = kMat && a.image;
  sc.tri_uv = kMat && a.tri_uv;
  sc.bilinear = kMat && a.bilinear;
  sc.needs_uv = sc.uv_space || sc.image;
  if constexpr (kMat) {  // the tables of the features added last
    sc.env_img = a.env_img;
    sc.env_smp = a.env_smp;
    sc.env_pick = sc.env_map ? __ldg(a.env_pick) : 0.0f;
    sc.env_k = a.env_k;
    sc.atlas = a.atlas;
    sc.atlas_k = a.atlas_k;
    sc.tri_uvs = a.tri_uvs;
    sc.cl_uv = a.cl_uv;
  }
  // the optional columns in pack_pt_scene's fixed order
  int col = kMatW;
  sc.c_tex = col;
  col += sc.texture ? 4 : 0;
  sc.c_space = col;
  col += sc.uv_space ? 1 : 0;
  sc.c_rect = col;
  col += sc.image ? 4 : 0;
  if constexpr (kTex) {
    sc.normal_map = a.normal_map != 0;
    sc.n_mips = a.n_mips;
    sc.tacc = a.tacc != 0;
    sc.lod_alpha = a.lod_alpha;
    sc.c_mips = col;
    col += 4 * sc.n_mips;
    sc.c_nrm = col;
    col += sc.normal_map ? 5 : 0;
  }
  sc.c_rough = col;
  col += sc.metal ? 1 : 0;
  sc.c_rough2 = col;
  col += sc.aniso ? 1 : 0;
  sc.c_disp = col;
  sc.S = a.S;
  sc.T = a.T;
  sc.M = a.M;
  sc.L = a.L;
  sc.n_sph = min(max(__ldg(a.counts), 0), a.S);
  sc.n_tri = min(max(__ldg(a.counts + 1), 0), a.T);
  sc.n_light = min(max(__ldg(a.counts + 3), 0), a.L);
  sc.total_power = __ldg(a.light + 8);
  sc.cl = a.cl;
  sc.inst = a.inst;
  sc.mesh = a.cl.trec != nullptr;
  sc.instanced = sc.mesh && a.inst.tab != nullptr;
  return sc;
}

// The light features' flags and tables (the light forms, kLights; the
// tables stay in global memory, read through the read-only path).
__device__ __forceinline__ Lights stage_lights(const Args& a) {
  Lights lt;
  lt.fog = a.fog_density > 0.0f;
  lt.media = a.fog_scatter > 0.0f;
  lt.fog_density = a.fog_density;
  lt.fog_scatter = a.fog_scatter;
  lt.fog_color = make_float3(a.fog_r, a.fog_g, a.fog_b);
  lt.tree = a.tree != 0;
  lt.n_clusters = a.n_clusters;
  lt.lt = a.lt;
  lt.lane_mesh = a.mlt_k > 0;
  lt.mlt_rows = a.mlt_rows;
  lt.mlt_smp = a.mlt_smp;
  lt.mlt_k = a.mlt_k;
  lt.mesh_area = lt.lane_mesh ? __ldg(a.mlt_meta) : 0.0f;
  lt.mesh_pick = lt.lane_mesh ? __ldg(a.mlt_meta + 1) : 0.0f;
  return lt;
}

// Exact ray count: warp sum, one shared add per warp, one atomic per block.
__device__ __forceinline__ void count_rays(const Args& a, unsigned* block_rays, int tid,
                                           unsigned nrays) {
  const unsigned warp_sum = __reduce_add_sync(0xFFFFFFFFu, nrays);
  if ((tid & 31) == 0 && warp_sum) atomicAdd(block_rays, warp_sum);
  __syncthreads();
  if (tid == 0 && *block_rays) {
    atomicAdd(a.nrays, static_cast<unsigned long long>(*block_rays));
  }
}

__device__ __forceinline__ uint32_t pass_seed(const Args& a, int s) {
  return static_cast<uint32_t>(a.seed) + static_cast<uint32_t>(a.spp_offset + s) * kPassPrime;
}

// K4's body, for each instantiation.
template <int kMesh, bool kMat, bool kTex, bool kSamp, bool kLights = false>
__device__ __forceinline__ void pt_body(const Args& a) {
  using B = K4<kMesh>;
  extern __shared__ float tables[];
  __shared__ unsigned block_rays;
  const int tid = threadIdx.y * B::kBlockX + threadIdx.x;
  const Scene sc = stage_scene<B::kThreads, kMat, kTex>(a, tables, tid);
  if (tid == 0) block_rays = 0u;
  __syncthreads();

  const int x = blockIdx.x * B::kBlockX + threadIdx.x;
  const int y = blockIdx.y * B::kBlockY + threadIdx.y;
  // an adaptive pass (kSamp) traces a pixel only while its cell takes
  // passes; a pixel of a stopped cell is as one past the ragged edges
  const bool in_image =
      x < a.w && y < a.h &&
      (!kSamp || a.active == nullptr || a.active[(y / a.cell_h) * a.grid_w + x / a.cell_w] != 0);
  unsigned nrays = 0u;
  // the warp form: every lane runs both loops, a lane past the ragged edges
  // with live false throughout (it writes nothing)
  if (B::kWarp || in_image) {
    const float3 cam = make_float3(__ldg(a.cam_pos), __ldg(a.cam_pos + 1), __ldg(a.cam_pos + 2));
    const float4 q = make_float4(__ldg(a.cam_quat), __ldg(a.cam_quat + 1),
                                 __ldg(a.cam_quat + 2), __ldg(a.cam_quat + 3));
    const uint32_t px = static_cast<uint32_t>(x);
    const uint32_t py = static_cast<uint32_t>(y + a.row0);
    float3 acc = make_float3(0.0f, 0.0f, 0.0f);
    Lights lt;  // the light features' (kLights)
    if constexpr (kLights) lt = stage_lights(a);
    for (int s = 0; s < a.spp; ++s) {
      const uint32_t seed = pass_seed(a, s);
      const uint32_t gpass = static_cast<uint32_t>(a.spp_offset + s);
      Ray r = camera_ray<kSamp>(a, px, py, seed, gpass, cam, q);
      const float* mesh_row = nullptr;  // pass s's mesh-light row (kLights, per pass)
      if constexpr (kLights) {
        if (a.mesh_rows != nullptr) mesh_row = a.mesh_rows + s * kPassRowW;
      }
      if constexpr (B::kWarp) {
        // a lane whose path has ended bounces with live false (a parked ray)
        // until no lane of the warp has a live path
        for (int b = 0; b <= a.max_bounces; ++b) {
          const bool live = in_image && r.alive;
          if (!__any_sync(cl::kFullWarp, live)) break;
          bounce<kMesh, true, kMat, kTex, kSamp, kLights>(a, sc, r, b, seed, gpass, nrays, live,
                                                          &lt, mesh_row);
        }
      } else {
        for (int b = 0; b <= a.max_bounces && r.alive; ++b) {
          bounce<kMesh, false, kMat, kTex, kSamp, kLights>(a, sc, r, b, seed, gpass, nrays, true,
                                                           &lt, mesh_row);
        }
      }
      acc = add3(acc, r.rad);
    }
    if (in_image) {
      const float inv = 1.0f / static_cast<float>(a.spp);
      float* out = a.out + (static_cast<size_t>(y) * a.w + x) * 3;
      out[0] = acc.x * inv;
      out[1] = acc.y * inv;
      out[2] = acc.z * inv;
    }
  }
  count_rays(a, &block_rays, tid, nrays);
}

// K5's body, for each instantiation.
template <bool kMat, bool kTex, bool kSamp, bool kLights = false>
__device__ __forceinline__ void pt_rebin_body(const Args& a) {
  extern __shared__ float tables[];
  __shared__ unsigned block_rays;
  const int tid = threadIdx.x;
  const Scene sc = stage_scene<kRebinThreads, kMat, kTex>(a, tables, tid);
  if (tid == 0) block_rays = 0u;
  __syncthreads();

  const int i = blockIdx.x * kRebinThreads + tid;
  const size_t n = static_cast<size_t>(a.n_state);
  unsigned nrays = 0u;
  const uint32_t seed = pass_seed(a, 0);
  const uint32_t gpass = static_cast<uint32_t>(a.spp_offset);
  // every lane enters bounce (the warp sweeps together); a lane past the
  // ragged end or holding a dead ray (|o.x| >= 1e17: the per-thread form of
  // the TPU kernel's skip_dead) carries a parked ray, with live false, and
  // leaves its state unchanged
  Ray r;
  park(r);
  r.rad = make_float3(0.0f, 0.0f, 0.0f);
  r.px = 0u;
  r.py = 0u;
  r.chan = -1.0f;
  r.tacc = 0.0f;
  bool live = i < a.n_state;
  float* st = a.state + (live ? i : 0);
  if (live) {
    if (a.bounce == 0) {
      const float3 cam = make_float3(__ldg(a.cam_pos), __ldg(a.cam_pos + 1), __ldg(a.cam_pos + 2));
      const float4 q = make_float4(__ldg(a.cam_quat), __ldg(a.cam_quat + 1),
                                   __ldg(a.cam_quat + 2), __ldg(a.cam_quat + 3));
      r = camera_ray<kSamp>(a, static_cast<uint32_t>(i % a.w),
                            static_cast<uint32_t>(i / a.w + a.row0), seed, gpass, cam, q);
    } else {
      const float ox = st[0];
      live = fabsf(ox) < cl::kParked;
      if (live) {
        r.o = make_float3(ox, st[n], st[2 * n]);
        r.d = make_float3(st[3 * n], st[4 * n], st[5 * n]);
        r.thr = make_float3(st[6 * n], st[7 * n], st[8 * n]);
        r.rad = make_float3(st[9 * n], st[10 * n], st[11 * n]);
        r.alive = st[12 * n] != 0.0f;
        r.prev_did_nee = st[13 * n] != 0.0f;
        r.prev_pdf = st[14 * n];
        r.px = static_cast<uint32_t>(st[15 * n]);
        r.py = static_cast<uint32_t>(st[16 * n]);
        if (sc.dispersion) r.chan = st[17 * n];
        if constexpr (kTex) {
          if (sc.tacc) r.tacc = st[(sc.dispersion ? 18 : 17) * n];
        }
      }
    }
  }
  Lights lt;  // the light features' (kLights), with the launch's pass's mesh-light row
  if constexpr (kLights) lt = stage_lights(a);
  bounce<kMeshAny, true, kMat, kTex, kSamp, kLights>(a, sc, r, a.bounce, seed, gpass, nrays, live,
                                                     &lt, a.mesh_rows);
  if (live) {
    const float planes[kStatePlanes] = {
        r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z, r.thr.x, r.thr.y, r.thr.z,
        r.rad.x, r.rad.y, r.rad.z, r.alive ? 1.0f : 0.0f, r.prev_did_nee ? 1.0f : 0.0f,
        r.prev_pdf, static_cast<float>(r.px), static_cast<float>(r.py)};
#pragma unroll
    for (int k = 0; k < kStatePlanes; ++k) st[k * n] = planes[k];
    if (sc.dispersion) st[kStatePlanes * n] = r.chan;
    if constexpr (kTex) {
      if (sc.tacc) st[(sc.dispersion ? kStatePlanes + 1 : kStatePlanes) * n] = r.tacc;
    }
  }
  count_rays(a, &block_rays, tid, nrays);
}

inline size_t table_bytes(const Args* a) {
  const bool mat = a->material != 0;
  const size_t mat_w = mat ? static_cast<size_t>(a->mat_w) : kMatW;
  const size_t env = mat && a->sky ? kEnvW : 0;
  return sizeof(float) * (static_cast<size_t>(a->S) * kSphW + static_cast<size_t>(a->T) * kTriW +
                          static_cast<size_t>(a->M) * mat_w + static_cast<size_t>(a->L) * kLightW +
                          env);
}

}  // namespace pt
