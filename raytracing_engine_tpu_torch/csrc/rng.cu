// Kernel K9, threefry2x32 uniforms, for Hopper (sm_90a), and its C entry
// point (bound with ctypes by ops/cuda/rng.py and ops/cuda/common.py).
//
// Replaces raytracing_engine_tpu/ops/pallas/rng.py:_rng_kernel (launched by
// uniform_planes): (n, H, W) float32 uniforms in [0, 1). The TPU kernel
// seeds the TPU's hardware generator per tile, a stream no other backend
// has; off the TPU the JAX package draws jax.random's threefry stream in
// its place (rng.py:59-65), and its path tracer's default rng="threefry"
// draws the same stream from other keys. This kernel computes that stream:
// element (p, r, c) of the full (n, h, w) draw under key (k0, k1) is
//   ctr  = p*h*w + r*w + c                      (64-bit, row-major)
//   y    = threefry2x32((k0, k1), (ctr >> 32, ctr & 0xFFFFFFFF))
//   bits = y.x ^ y.y
//   u    = bitcast((bits >> 9) | 0x3F800000) - 1.0f
// as jax.random.uniform does with jax_threefry_partitionable on, so it
// equals ops/rng.py's plain version, and JAX, bit for bit.
//
// A launch writes only rows row0 .. row0 + band_h of the draw (the counter
// keeps the full draw's row), so a band equals the same rows of the full
// draw; the JAX package draws the full image and slices.
//
// What bounds it on this card: integer operations. An element costs 75 of
// them (20 rounds of add, rotate and xor; 12 key additions; the xor of the
// two words, a shift and an or) and one float subtraction, and writes 4
// bytes. The 41 rotations and xors need the INT32 lanes (the additions may
// also run on the FP32 pipe): at (8, 1088, 1920) 6.9e8 of them take
// 0.041 ms against 0.020 ms for the 67 MB (utils/timing.py). So one thread
// per element, the rotations as funnel shifts, the key schedule in
// registers, consecutive threads on consecutive elements of a plane so the
// stores coalesce; nothing is staged.
//
// Grid: x over the band's elements of one plane (kBlock per block, the
// ragged end masked), y over the planes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
#include <cstdint>

#include <cuda_runtime.h>

namespace rng {

constexpr int kBlock = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneBits = 0x3F800000u;  // 1.0f

// Launch arguments, passed by value. Mirrored field for field by RngArgs in
// ops/cuda/rng.py.
struct Args {
  float* out;          // (n, band_h, w) uniforms
  unsigned int k0;     // the key's two words
  unsigned int k1;
  int n, h, w;         // the full draw's shape
  int row0, band_h;    // the rows written
  int device;          // CUDA ordinal the pointer and the stream belong to
};

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// Threefry-2x32, 20 rounds (JAX prng.py _threefry2x32_lowering)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__global__ void __launch_bounds__(kBlock) rng_kernel(const Args a) {
  const long long plane = static_cast<long long>(a.band_h) * a.w;
  const long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (j >= plane) return;
  const unsigned long long p = blockIdx.y;
  const unsigned long long ctr =
      p * a.h * a.w + static_cast<unsigned long long>(a.row0) * a.w + j;
  const uint2 y = threefry2x32(a.k0, a.k1, static_cast<uint32_t>(ctr >> 32),
                               static_cast<uint32_t>(ctr));
  const uint32_t bits = y.x ^ y.y;
  a.out[p * plane + j] = __uint_as_float((bits >> 9) | kOneBits) - 1.0f;
}

}  // namespace rng

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int rng_uniform(const rng::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long plane = static_cast<long long>(a->band_h) * a->w;
  if (a->n > 0 && plane > 0) {
    const dim3 grid(static_cast<unsigned int>((plane + rng::kBlock - 1) / rng::kBlock),
                    static_cast<unsigned int>(a->n));
    rng::rng_kernel<<<grid, rng::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
