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
// Block: 32 x 4 threads, a warp along a row; the ragged edge (level widths
// such as 120 and 240 at 1920x1088) is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see conemarch.cuh on why
//        no FMA contraction and no fast math)
#include "conemarch.cuh"

namespace conemarch {

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;

// Replaces raytracing_engine_tpu/ops/pallas/depth.py:_depth_kernel (K1):
// one pyramid level, seeded from the previous level's pixel [y/2, x/2] (the
// JAX path's upsample_seed gather is folded into this load).
__global__ void __launch_bounds__(kBlockX * kBlockY) depth_kernel(const Args a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const Spheres s = load_spheres(a);
  const float3 d = ray_dir(a, x, y);
  a.out[static_cast<size_t>(y) * a.w + x] = march_depth(a, s, d, x, y);
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
// register; (h, w, 3) out, equal bit for bit to depth_kernel + shade_kernel.
__global__ void __launch_bounds__(kBlockX * kBlockY) fused_kernel(const Args a) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.w || y >= a.h) return;
  const size_t i = static_cast<size_t>(y) * a.w + x;
  const Spheres s = load_spheres(a);
  const float3 d = ray_dir(a, x, y);
  const float3 c = shade_pixel(a, s, d, march_depth(a, s, d, x, y));
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
extern "C" int conemarch_depth(const Args* a, void* stream) {
  const cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  conemarch::depth_kernel<<<grid_for(a), dim3(kBlockX, kBlockY), 0,
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
