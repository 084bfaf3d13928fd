// Kernels K4 (the path-tracing megakernel) and K5 (one bounce per launch)
// for Hopper (sm_90a), and their C entry points (bound with ctypes by
// ops/cuda/pt.py and ops/cuda/common.py).
//
// K4 replaces raytracing_engine_tpu/ops/pallas/pt_kernel.py:_pt_kernel for
// scenes of spheres and up to TRI_UNROLL_MAX unrolled triangles, of spheres
// and a mesh given as a ClusterSet, or of spheres and instances of such a
// mesh (BASELINE configs 2, 3, 4 and 5's path-traced cell), one
// instantiation for each of these mesh kinds (pt.cuh kMesh*; pt_render
// picks it from the tables): the whole path of a pixel (camera ray, spp
// loop, bounce loop, NEE + MIS, the PCG4D stream keyed on global pixel
// coordinates) runs in one thread, in registers.
//
// Each kernel has a second instantiation for the material features (pt.cuh
// kMat: GGX metal, anisotropy, rough glass, checkers in world or UV space,
// image textures, dispersion, the gradient sky, the env map; the branches of
// JAX's static flags, pt_kernel.py:200-206 and :707-713): a scene with none
// of them launches the instantiation it launched before, so configs 2-5 pay
// no registers for GGX. A third one of each, pt_tex_kernel<kMesh> and
// pt_rebin_tex_kernel (pt.cuh kTex), adds the texture features that read the
// hit's texture-u tangent or a UV table under instances: normal maps, the
// mip chains' trilinear filter with its ray cone, instances of a UV
// ClusterSet; the material scenes without them keep their instantiation.
//
// The sampling features run in a sampling form of each of those
// instantiations (pt.cuh kSamp: pt_samp_kernel<kMesh, kMat>,
// pt_samp_tex_kernel<kMesh>, pt_rebin_samp_kernel<kMat>,
// pt_rebin_samp_tex_kernel; ops/cuda/pt.py sets Args.samp): the thin lens
// (JAX's cfg.aperture), the R_d sampler's camera and bounce-0 NEE dimensions
// (cfg.sampler="r2") and K4's adaptive passes, so a render without them
// launches the instantiation it launched before, instruction for
// instruction. Adaptive spp (pt_kernel.py:310-370) runs as one K4 launch a
// pass, each pixel tracing while its grid cell's flag is set, then
// pt_cell_kernel (below) over the cells; the host enqueues every pass and
// reads nothing back between them.
//
// K5 replaces pt_kernel.py:_pt_rebin_kernel (render_pt_rebin): one launch
// per bounce over a packed 17-plane ray state (then dispersion's chan and the
// trilinear filter's tacc). Thread i owns the ray at
// sorted rank i: bounce 0 makes the camera ray of pixel i of the band,
// later launches read the state at rank i and write it back in place. A dead
// ray (|o.x| >= 1e17) leaves its state unchanged: the per-thread form of the
// TPU kernel's skip_dead. Between launches the wrapper regroups the rays
// (a stable sort on a coherence key, then a permutation of every plane).
// Both kernels run the same `bounce` (pt.cuh), so K5 equals K4 bit for bit.
//
// What bounds them on this card: FP32 ALU work, divergence and latency, not
// bytes. Each segment tests every live sphere and then every unrolled
// triangle or the cluster hierarchy (box tests and Baldwin–Weber tests), per
// instance entered with instances (instanced.cuh); paths end at different
// bounces. K4 writes only its output (5.8 MB at config 2); K5 moves 17
// planes in and out per bounce (36 MB at 512², well under its sweep work at
// config 3). So: one thread per ray; the scene tables load once per block
// into shared memory (broadcast reads). Without a mesh (K4's kMeshNone) a
// thread that misses or dies stops and warps retire on their own: there is
// no sweep to share. A mesh is swept with the warp's lanes together
// (cluster.cuh sweep_warp, instanced.cuh instanced_sweep_warp): measured
// before that design (PERF.md §5), one thread a ray
// ran K5's sub-box tests on 1.5-2.3 of 32 lanes, each a serial loop of 32
// record loads from the L2; now a sub-box that few lanes enter is loaded
// once, coalesced, and tested by the whole warp. In K4's mesh
// instantiations every lane runs the spp loop and the bounce loop, until no
// lane of its warp has a live path (full-mask votes). Both kernels read the
// cluster tables through the read-only path (9.7 MB at config 3, in the L2).
// None of the TPU layout is kept: no tiles, stripes, f32 alive masks or
// SMEM/VMEM packing.
//
// Rays are counted exactly: one per live path per bounce, one per NEE
// shadow-ray candidate; a warp-level sum, one shared-memory add per warp and
// one 64-bit integer atomicAdd per block.
//
// Blocks: K4 16 x 8 threads (a warp covers 16 x 2 pixels), 8 x 16 with
// instances (8 x 4), every lane of a mesh instantiation's warp in the loops
// (those past the ragged edges without a ray); K5 256 threads over
// consecutive ranks, every lane of a warp in the sweeps (those past the
// ragged end and those of dead rays without a ray). Ragged edges are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see pt.cuh on why no FMA
//        contraction and no fast math)
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
template <int kMesh, bool kMat, bool kTex, bool kSamp>
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
    for (int s = 0; s < a.spp; ++s) {
      const uint32_t seed = pass_seed(a, s);
      const uint32_t gpass = static_cast<uint32_t>(a.spp_offset + s);
      Ray r = camera_ray<kSamp>(a, px, py, seed, gpass, cam, q);
      if constexpr (B::kWarp) {
        // a lane whose path has ended bounces with live false (a parked ray)
        // until no lane of the warp has a live path
        for (int b = 0; b <= a.max_bounces; ++b) {
          const bool live = in_image && r.alive;
          if (!__any_sync(cl::kFullWarp, live)) break;
          bounce<kMesh, true, kMat, kTex, kSamp>(a, sc, r, b, seed, gpass, nrays, live);
        }
      } else {
        for (int b = 0; b <= a.max_bounces && r.alive; ++b) {
          bounce<kMesh, false, kMat, kTex, kSamp>(a, sc, r, b, seed, gpass, nrays);
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

template <int kMesh, bool kMat>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_kernel(const Args a) {
  pt_body<kMesh, kMat, false, false>(a);
}

// K4's texture instantiation (pt.cuh kTex), beside pt_kernel so that its
// instantiations keep their names.
template <int kMesh>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_tex_kernel(const Args a) {
  pt_body<kMesh, true, true, false>(a);
}

// K4's sampling instantiations (kSamp: the thin lens, R_d, adaptive passes),
// without and with the material features, and with the texture features.
template <int kMesh, bool kMat>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_samp_kernel(const Args a) {
  pt_body<kMesh, kMat, false, true>(a);
}
template <int kMesh>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_samp_tex_kernel(const Args a) {
  pt_body<kMesh, true, true, true>(a);
}

// K5's body, for each instantiation.
template <bool kMat, bool kTex, bool kSamp>
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
  bounce<kMeshAny, true, kMat, kTex, kSamp>(a, sc, r, a.bounce, seed, gpass, nrays, live);
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

template <bool kMat>
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_kernel(const Args a) {
  pt_rebin_body<kMat, false, false>(a);
}

// K5's texture instantiation (pt.cuh kTex).
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_tex_kernel(const Args a) {
  pt_rebin_body<true, true, false>(a);
}

// K5's sampling instantiations (kSamp: the thin lens, R_d).
template <bool kMat>
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_samp_kernel(const Args a) {
  pt_rebin_body<kMat, false, true>(a);
}
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_samp_tex_kernel(const Args a) {
  pt_rebin_body<true, true, true>(a);
}

// K4's adaptive spp, after each pass (ops/pallas/pt_kernel.py:310-356, the
// while_loop's body and cond): one block a cell, which skips a stopped cell.
// Each pixel of an active cell adds the pass to acc and updates the Welford
// mean and M2 of its luminance (a true division, no FMA); the block sums the
// pixels' standard errors sqrt(max(M2 / max(s - 1, 1) / max(s, 1), 0)) and
// means pairwise, element i with element i + half at every level (the order
// of ops/cuda/pt.py cell_sums, so the plain version decides each cell as
// this kernel does), through the cell's rows of scratch; the cell takes
// another pass while s < min_spp, or while s < spp and the relative error
// mean(se) / max(mean(mean), 1e-4) exceeds tol, and else writes its pixels'
// acc * (1 / s). Bound by bytes: each pixel's 9 floats read and 6 written
// once a pass, the sums' levels in the L2.
constexpr int kAdaptThreads = 256;

__device__ __forceinline__ void adapt_pixel(const AdaptArgs& a, int cell_i, int cell_j, int j,
                                            float sf, float& se, float& mu) {
  se = 0.0f;  // past the cell's pixels: the sums' zero padding
  mu = 0.0f;
  if (j >= a.cell_h * a.cell_w) return;
  const size_t p = static_cast<size_t>(cell_i * a.cell_h + j / a.cell_w) * a.w +
                   cell_j * a.cell_w + j % a.cell_w;
  const float r = a.rad[3 * p], g = a.rad[3 * p + 1], b = a.rad[3 * p + 2];
  a.acc[3 * p] = a.acc[3 * p] + r;
  a.acc[3 * p + 1] = a.acc[3 * p + 1] + g;
  a.acc[3 * p + 2] = a.acc[3 * p + 2] + b;
  const float x = 0.2126f * r + 0.7152f * g + 0.0722f * b;
  const float d = x - a.mean[p];
  const float mean = a.mean[p] + d / sf;
  const float m2 = a.m2[p] + d * (x - mean);
  a.mean[p] = mean;
  a.m2[p] = m2;
  const float var = m2 / vmax(sf - 1.0f, 1.0f);
  se = sqrtf(vmax(var / vmax(sf, 1.0f), 0.0f));
  mu = mean;
}

__global__ void __launch_bounds__(kAdaptThreads) pt_cell_kernel(const AdaptArgs a) {
  const int c = blockIdx.x;
  if (a.active[c] == 0) return;  // the whole block: a stopped cell
  const int ci = c / a.grid_w, cj = c % a.grid_w;
  const int n = a.cell_h * a.cell_w;
  const float sf = static_cast<float>(a.s);
  float* s_se = a.scratch + static_cast<size_t>(c) * 2 * (a.half > 0 ? a.half : 1);
  float* s_mu = s_se + (a.half > 0 ? a.half : 1);
  if (a.half == 0) {  // a cell of one pixel
    if (threadIdx.x == 0) adapt_pixel(a, ci, cj, 0, sf, s_se[0], s_mu[0]);
  } else {
    for (int i = threadIdx.x; i < a.half; i += kAdaptThreads) {
      float se0, mu0, se1, mu1;
      adapt_pixel(a, ci, cj, i, sf, se0, mu0);
      adapt_pixel(a, ci, cj, i + a.half, sf, se1, mu1);
      s_se[i] = se0 + se1;
      s_mu[i] = mu0 + mu1;
    }
    for (int stride = a.half / 2; stride >= 1; stride /= 2) {
      __syncthreads();
      for (int i = threadIdx.x; i < stride; i += kAdaptThreads) {
        s_se[i] = s_se[i] + s_se[i + stride];
        s_mu[i] = s_mu[i] + s_mu[i + stride];
      }
    }
  }
  __syncthreads();
  const float se = s_se[0] / static_cast<float>(n);
  const float rel = se / vmax(s_mu[0] / static_cast<float>(n), 1e-4f);
  const bool more = a.s < a.min_spp || (a.s < a.spp && rel > a.tol);
  if (!more) {
    const float inv = 1.0f / sf;
    for (int j = threadIdx.x; j < n; j += kAdaptThreads) {
      const size_t p = static_cast<size_t>(ci * a.cell_h + j / a.cell_w) * a.w +
                       cj * a.cell_w + j % a.cell_w;
      a.out[3 * p] = a.acc[3 * p] * inv;
      a.out[3 * p + 1] = a.acc[3 * p + 1] * inv;
      a.out[3 * p + 2] = a.acc[3 * p + 2] * inv;
    }
  }
  __syncthreads();  // every thread has read active[c]
  if (threadIdx.x == 0) {
    a.taken[c] = sf;
    if (!more) a.active[c] = 0;
  }
}

size_t table_bytes(const Args* a) {
  const bool mat = a->material != 0;
  const size_t mat_w = mat ? static_cast<size_t>(a->mat_w) : kMatW;
  const size_t env = mat && a->sky ? kEnvW : 0;
  return sizeof(float) * (static_cast<size_t>(a->S) * kSphW + static_cast<size_t>(a->T) * kTriW +
                          static_cast<size_t>(a->M) * mat_w + static_cast<size_t>(a->L) * kLightW +
                          env);
}

// K4 at mesh kind kMesh, its texture instantiation where the scene has the
// texture features, else its material instantiation where it has any of the
// material features; each in its sampling form where a->samp.
template <int kMesh>
cudaError_t launch_pt(const Args* a, cudaStream_t stream) {
  using B = K4<kMesh>;
  const dim3 grid((a->w + B::kBlockX - 1) / B::kBlockX, (a->h + B::kBlockY - 1) / B::kBlockY);
  const dim3 block(B::kBlockX, B::kBlockY);
  const size_t smem = table_bytes(a);
  if (a->samp) {
    if (a->tex) {
      pt_samp_tex_kernel<kMesh><<<grid, block, smem, stream>>>(*a);
    } else if (a->material) {
      pt_samp_kernel<kMesh, true><<<grid, block, smem, stream>>>(*a);
    } else {
      pt_samp_kernel<kMesh, false><<<grid, block, smem, stream>>>(*a);
    }
  } else if (a->tex) {
    pt_tex_kernel<kMesh><<<grid, block, smem, stream>>>(*a);
  } else if (a->material) {
    pt_kernel<kMesh, true><<<grid, block, smem, stream>>>(*a);
  } else {
    pt_kernel<kMesh, false><<<grid, block, smem, stream>>>(*a);
  }
  return cudaGetLastError();
}

}  // namespace pt

// Launch K4 on `stream` (a cudaStream_t), its instantiation for the mesh
// kind of the tables it is given; does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int pt_render(const pt::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->cl.trec == nullptr) return static_cast<int>(pt::launch_pt<pt::kMeshNone>(a, s));
  if (a->inst.tab == nullptr) return static_cast<int>(pt::launch_pt<pt::kMeshClusters>(a, s));
  return static_cast<int>(pt::launch_pt<pt::kMeshInstances>(a, s));
}

// Launch K5 (bounce a->bounce over a->state) on `stream`; as pt_render.
extern "C" int pt_rebin(const pt::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n_state > 0) {
    const dim3 grid((a->n_state + pt::kRebinThreads - 1) / pt::kRebinThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = pt::table_bytes(a);
    if (a->samp) {
      if (a->tex) {
        pt::pt_rebin_samp_tex_kernel<<<grid, pt::kRebinThreads, smem, s>>>(*a);
      } else if (a->material) {
        pt::pt_rebin_samp_kernel<true><<<grid, pt::kRebinThreads, smem, s>>>(*a);
      } else {
        pt::pt_rebin_samp_kernel<false><<<grid, pt::kRebinThreads, smem, s>>>(*a);
      }
    } else if (a->tex) {
      pt::pt_rebin_tex_kernel<<<grid, pt::kRebinThreads, smem, s>>>(*a);
    } else if (a->material) {
      pt::pt_rebin_kernel<true><<<grid, pt::kRebinThreads, smem, s>>>(*a);
    } else {
      pt::pt_rebin_kernel<false><<<grid, pt::kRebinThreads, smem, s>>>(*a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the cell update of K4's adaptive pass a->s on `stream`; as pt_render.
extern "C" int pt_adapt(const pt::AdaptArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n_cells > 0) {
    pt::pt_cell_kernel<<<a->n_cells, pt::kAdaptThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
