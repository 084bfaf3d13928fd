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
// reads nothing back between them. The light features (fog and media, the
// light tree, mesh lights) run in light forms of their own, built apart in
// pt_lights.cu; K4's and K5's bodies, which both sources instantiate, are in
// pt_body.cuh.
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
#include "pt_body.cuh"

namespace pt {

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
