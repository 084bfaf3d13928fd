// The cone-march renderer's three kernels for Hopper (sm_90a), one thread
// per pixel, and their C entry points (bound with ctypes by ops/cuda/common.py).
//
// What bounds them on this card: divergent FP32 ALU work (square roots,
// divisions and compares of the march loops, up to 256 steps per ray and
// per shadow ray) with almost no memory traffic: a kernel reads one seed or
// depth float per pixel and writes 1 or 3 floats. Tensor cores, TMA and
// shared-memory staging have nothing to do here; the design keeps all ray
// state in registers and lets each warp retire as soon as its rays are done.
//
// Blocks: the shade and fused kernels 32 x 4 threads, a warp along a row;
// the pyramid kernel kTileX x kTileY threads, a tile of one level. The
// ragged edge (level widths such as 120 and 240 at 1920x1088) is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see conemarch.cuh on why
//        no FMA contraction and no fast math)
#include "conemarch.cuh"

namespace conemarch {

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;

// Replaces raytracing_engine_tpu/ops/pallas/depth.py:_depth_kernel (K1):
// the pyramid levels first..last in one launch. The TPU kernel marches one
// level a launch; here a launch a level left most of the card idle (five of
// a 1920x1088 frame's eight coarse levels have fewer blocks than the card
// has SMs) and made every tile of a level wait for the slowest ray of the
// whole level before it. So the launch has one block a tile of every level,
// and a tile waits only for the one tile of the level before that holds
// its pixels' parents [y/2, x/2]: the tile (bx/2, by/2), since a level is at
// most twice its parent (ceil(2a) <= 2 ceil(a)) and a tile is kTileX x
// kTileY at every level. Each pixel is marched once, and every pixel of
// every level is written out, those no finer pixel reads included.
//
// Blocks take their tile from a ticket counter, not from blockIdx, so the
// tiles start in level order: every tile a block waits for belongs to a
// block that started before it and is resident or done, and a waiting block
// cannot hold the card from the tile it waits for. A written tile sets its
// flag to the launch's epoch (release, after every thread's write and a
// barrier); a block reads its parents through L2 (__ldcg) after it has seen
// the flag (acquire). The last block to finish zeroes the counters for the
// next launch on the stream; flags need no reset, as each launch has a new
// epoch. A wait that outlasts kMaxSpins polls traps (a launch error, not a
// hung card). With first == last it is one level, seeded from src, and no
// block waits. The per-pixel math is the plain level's (ray_dir_at and
// depth_from with the level's constants), so every level equals the plain
// pyramid bit for bit.
// A one-warp 4 x 8 tile, 16 blocks an SM asked (75 registers, no spills),
// measured fastest on the H100 against 32 x 1 to 32 x 8 tiles and 2 to 32
// blocks an SM (PERF.md §6): the smaller a tile, the fewer rays its
// children wait for.
constexpr int kTileX = 4;   // mirrored by ops/cuda/depth.TILE_W
constexpr int kTileY = 8;   // mirrored by ops/cuda/depth.TILE_H
constexpr int kPyramidMinBlocks = 16;  // resident blocks an SM asked of ptxas (__launch_bounds__)
constexpr int kMaxSpins = 1 << 24;    // polls of a parent's flag, 64 ns apart, before a trap

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kTileX * kTileY, kPyramidMinBlocks)
    pyramid_kernel(const Args a) {
  __shared__ int ticket;
  int* const next = a.sync;
  int* const done = a.sync + 1;
  int* const flags = a.sync + 2;
  const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
  if (lead) ticket = atomicAdd(next, 1);
  __syncthreads();
  const int t = ticket;
  int l = a.last;
  while (t < a.lvl_item[l]) --l;
  const int w = a.lvl_w[l], h = a.lvl_h[l];
  const int i = t - a.lvl_item[l], gx = (w + kTileX - 1) / kTileX;
  const int bx = i % gx, by = i / gx;
  const int x = bx * kTileX + threadIdx.x, y = by * kTileY + threadIdx.y;
  const bool inside = x < w && y < h;
  float seed = 1.0f;
  if (l > a.first) {
    const int pw = a.lvl_w[l - 1];
    if (lead) {
      const int* flag = flags + a.lvl_item[l - 1] + (by >> 1) * ((pw + kTileX - 1) / kTileX) +
                        (bx >> 1);
      for (int spins = 0; load_acquire(flag) != a.epoch; ++spins) {
        if (spins == kMaxSpins) __trap();
        __nanosleep(64);
      }
    }
    __syncthreads();
    if (inside) {
      seed = __ldcg(a.out + a.lvl_off[l - 1] + static_cast<size_t>(y >> 1) * pw + (x >> 1));
    }
  } else if (inside) {
    seed = src_seed(a, x, y);
  }
  if (inside) {
    const Spheres s = load_spheres(a);
    const float3 d = ray_dir_at(a, a.lvl_sx[l], a.lvl_sy[l], x, y);
    a.out[a.lvl_off[l] + static_cast<size_t>(y) * w + x] =
        depth_from(a, s, d, seed, a.lvl_thr[l]);
  }
  __syncthreads();
  if (lead) {
    __threadfence();
    store_release(flags + t, a.epoch);
    if (atomicAdd(done, 1) == a.items - 1) {
      atomicExch(next, 0);
      atomicExch(done, 0);
    }
  }
}

// Replaces raytracing_engine_tpu/ops/pallas/shade.py:_shade_kernel (K3):
// Phong shading and soft shadows from a finished depth image; (h, w, 3) out.
__global__ void __launch_bounds__(kBlockX * kBlockY) shade_kernel(const Args a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = static_cast<size_t>(y) * a.w + x;
  const Spheres s = load_spheres(a);
  const float3 d = ray_dir(a, x, y);
  const float3 c = shade_pixel(a, s, d, __ldg(a.src + i));
  a.out[3 * i] = c.x;
  a.out[3 * i + 1] = c.y;
  a.out[3 * i + 2] = c.z;
}

// Replaces raytracing_engine_tpu/ops/pallas/fused.py:_fused_kernel (K2):
// the finest level's march, then the shading of K3 with the depth kept in a
// register; (h, w, 3) out, equal bit for bit to pyramid_kernel + shade_kernel.
__global__ void __launch_bounds__(kBlockX * kBlockY) fused_kernel(const Args a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = static_cast<size_t>(y) * a.w + x;
  const Spheres s = load_spheres(a);
  const float3 d = ray_dir(a, x, y);
  const float3 c = shade_pixel(a, s, d, depth_from(a, s, d, src_seed(a, x, y), a.threshold));
  a.out[3 * i] = c.x;
  a.out[3 * i + 1] = c.y;
  a.out[3 * i + 2] = c.z;
}

inline dim3 grid_for(const Args* a) {
  return dim3((a->w + kBlockX - 1) / kBlockX, (a->h + kBlockY - 1) / kBlockY);
}

}  // namespace conemarch

using conemarch::Args;
using conemarch::grid_for;
using conemarch::kBlockX;
using conemarch::kBlockY;

// Each entry launches on `stream` (a cudaStream_t), does not synchronise, and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int conemarch_pyramid(const Args* a, void* stream) {
  const cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->first < 0 || a->first > a->last || a->last >= conemarch::kMaxLevels || a->items < 1 ||
      a->epoch == 0 || a->sync == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conemarch::pyramid_kernel<<<a->items, dim3(conemarch::kTileX, conemarch::kTileY), 0,
                              static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conemarch_shade(const Args* a, void* stream) {
  const cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  conemarch::shade_kernel<<<grid_for(a), dim3(kBlockX, kBlockY), 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conemarch_fused(const Args* a, void* stream) {
  const cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  conemarch::fused_kernel<<<grid_for(a), dim3(kBlockX, kBlockY), 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conemarch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
