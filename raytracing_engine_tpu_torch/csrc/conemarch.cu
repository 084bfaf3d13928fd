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
// Blocks: the fused and the shade kernel a few one-warp tiles of the image
// each (WarpTiles in conemarch.cuh: kFusedWarp* and kShadeWarp* below); the
// pyramid kernel kTileX x kTileY threads, a tile of one level. The ragged
// edge (level widths such as 120 and 240 at 1920x1088, or a width of 1000)
// is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see conemarch.cuh on why
//        no FMA contraction and no fast math)
#include "conemarch.cuh"

namespace conemarch {

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

// Replaces raytracing_engine_tpu/ops/pallas/fused.py:_fused_kernel (K2):
// the finest level's march, then the shading of K3 with the depth kept in a
// register; (h, w, 3) out, equal bit for bit to pyramid_kernel + shade_kernel.
//
// A warp is an 8 x 4 tile of the image, not a strip of a row: a march takes
// as many steps as the warp's slowest lane, and the pixels of a square tile
// are nearer alike (ab_config3.py --trips counts the lanes that step
// uselessly at each tile shape: 60% of the primary march's lanes are busy
// in 8 x 4 tiles, 44% in 32 x 1). Measured on the H100 (PERF.md §6): 8 x 4
// tiles in blocks of 2 x 2 against 32 x 1, 16 x 2 and 4 x 8 tiles and
// blocks of 1 to 8 warps; marching the shadow rays as jobs off the pixel's
// lane (a list of (pixel, light) jobs a warp or a block) and shading the
// finest level inside K1's launch both lost, and so did asking ptxas for a
// number of resident blocks (its code for the same 55 registers ran 6.5%
// slower).
constexpr int kFusedWarpX = 8;   // a warp's tile: kFusedWarpX x (32 / kFusedWarpX) pixels
constexpr int kFusedWarpsX = 2;  // a block: kFusedWarpsX x kFusedWarpsY warp tiles
constexpr int kFusedWarpsY = 2;
using FusedTiles = WarpTiles<kFusedWarpX, kFusedWarpsX, kFusedWarpsY>;

__global__ void __launch_bounds__(FusedTiles::kThreads) fused_kernel(const Args a) {
  const int2 p = FusedTiles::pixel();
  if (p.x >= a.w || p.y >= a.h) return;
  const size_t i = static_cast<size_t>(p.y) * a.w + p.x;
  const Spheres s = load_spheres(a);
  const float3 d = ray_dir(a, p.x, p.y);
  const float3 c = shade_pixel(a, s, d, depth_from(a, s, d, src_seed(a, p.x, p.y), a.threshold));
  a.out[3 * i] = c.x;
  a.out[3 * i + 1] = c.y;
  a.out[3 * i + 2] = c.z;
}

// Replaces raytracing_engine_tpu/ops/pallas/shade.py:_shade_kernel (K3):
// Phong shading and soft shadows from a finished depth image; (h, w, 3) out,
// through K2's shade_pixel, so that K2's image equals K1 + K3 bit for bit.
//
// Its warps are one-warp 8 x 4 tiles of the image, in blocks of 2 x 2, as
// K2's (WarpTiles): a warp marches as many shadow steps as its slowest lane,
// and the lanes of a square tile are nearer alike (ab_config3.py --trips:
// 15% fewer shadow warp-steps than rows of 32). A sky pixel, most of a
// frame, reads its depth, writes black and leaves before it loads the scene
// or makes its ray.
//
// Registers: K2's march reads the scene's 32 floats before any divergent
// branch, and ptxas moves them into uniform registers there (55 a thread);
// here their first use follows the sky test, and ptxas keeps them in vector
// registers (90 a thread, 5 blocks an SM). A cap of 56 (__maxnreg__, which
// nvcc takes only without __launch_bounds__) spills 132 B a thread to L1
// and holds 9 blocks an SM: it is the fastest form measured on the H100
// (PERF.md §6), against 8 x 4, 4 x 8, 16 x 2 and 32 x 1 tiles, blocks of 8
// warps, caps from 40 to 72, the scene taken from lane 0 by __shfl_sync or
// kept in shared memory, and the parent's order (the scene loaded first).
constexpr int kShadeWarpX = 8;   // a warp's tile: kShadeWarpX x (32 / kShadeWarpX) pixels
constexpr int kShadeWarpsX = 2;  // a block: kShadeWarpsX x kShadeWarpsY warp tiles
constexpr int kShadeWarpsY = 2;
using ShadeTiles = WarpTiles<kShadeWarpX, kShadeWarpsX, kShadeWarpsY>;

__global__ void __maxnreg__(56) shade_kernel(const Args a) {
  const int2 p = ShadeTiles::pixel();
  if (p.x >= a.w || p.y >= a.h) return;
  const size_t i = static_cast<size_t>(p.y) * a.w + p.x;
  const float depth = __ldg(a.src + i);
  float3 c;
  if (!(depth < a.render_dist)) {  // the sky: shade_pixel's own first test
    c = make_float3(0.0f, 0.0f, 0.0f);
  } else {
    const Spheres s = load_spheres(a);
    c = shade_pixel(a, s, ray_dir(a, p.x, p.y), depth);
  }
  a.out[3 * i] = c.x;
  a.out[3 * i + 1] = c.y;
  a.out[3 * i + 2] = c.z;
}

}  // namespace conemarch

using conemarch::Args;

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
  using Tiles = conemarch::ShadeTiles;
  conemarch::shade_kernel<<<Tiles::grid(a->w, a->h), Tiles::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conemarch_fused(const Args* a, void* stream) {
  const cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using Tiles = conemarch::FusedTiles;
  conemarch::fused_kernel<<<Tiles::grid(a->w, a->h), Tiles::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conemarch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
