// Kernel K7, the instanced cluster intersector, for Hopper (sm_90a), and its
// C entry point (bound with ctypes by ops/cuda/instanced.py and
// ops/cuda/common.py).
//
// Replaces raytracing_engine_tpu/ops/pallas/instanced_intersect.py:
// _instanced_kernel (K7, launched by instanced_cluster_intersect): closest or
// any hit of a grid of rays against N instances of one base ClusterSet,
// with the world-space normal of the closest hit on request, and on a UV
// base table its texture UV and, on request, its world texture-u tangent
// (instanced_uv_kernel<kTan>: a base set without UVs runs the kernel it ran
// before). The two-level
// sweep itself is instanced.cuh's instanced_sweep_warp, over cluster.cuh's
// sweep_warp.
//
// What bounds it on this card: FP32 ALU work and latency, not bytes. A ray
// reads 7 floats and writes 2 (5 with the normal); it tests every instance's
// world box (28 operations), moves into the object space of the ones it
// enters (about 40), and runs the cluster sweep there (box tests of 28 and
// triangle tests of 30 operations). Measured before this design (PERF.md §5,
// ab_config3.py --lanes): on config 5's Phong camera rays the warp ran its
// sub-box tests with 6 of 32 lanes on average (19%), each a serial loop of
// 32 record loads. So: one ray a lane, the warp together (instanced.cuh
// instanced_sweep_warp over cluster.cuh sweep_warp): the lanes walk the
// instances and super orders in lockstep, each with its own gates, and a
// sub-box that up to 16 lanes enter is loaded once, coalesced, and tested by
// the whole warp; the near-to-far instance order lets a near hit cull the
// far instances' boxes. The tables are read through the read-only path and
// stay in the L1 and L2: the base set's 59,200 B of super boxes and cluster
// records at BASELINE config 5, its 5 MB of triangle records, the 30 x
// 96-byte instance table. Staging the box hierarchy in shared memory, once
// per block, measured slower here (0.858 against 0.727 ms on the
// 1080p camera rays, blocks of 256, PERF.md §6): each of a 1080p frame's
// 8,160 blocks copies 59 KB, and three blocks instead of four fit an SM.
//
// Block: 128 threads over consecutive rays (measured faster than 256: 0.658
// against 0.727 ms); every lane enters the sweep, those past the ragged end
// without a ray.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
#include "instanced.cuh"

namespace ins {

constexpr int kBlock = 128;

// Launch arguments, passed by value. Mirrored field for field by
// InstancedArgs in ops/cuda/instanced.py.
struct Args {
  cl::Tables tables;
  Instances inst;
  const float* ox;   // (n,) ray origins and directions, one plane each
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tmax;  // (n,) initial t (the any-hit cutoff)
  float* out_t;       // (n,) t of the hit, +inf on a miss
  int* out_code;      // (n,) instance * t_pad + slot, -1 on a miss
  float* out_n;       // (3, n) unnormalized world normal, or null
  int n;
  float t_min;
  int any_hit;
  int device;        // CUDA ordinal the pointers and the stream belong to
  const float* tuv;  // (T_pad, 8) the base set's UV records, or null
  float* out_uv;     // with tuv and out_n: (2, n) u, v, (5, n) with tx, ty, tz (tan)
  int tan;
};

// The kernel's body: kAttr as instanced_sweep_warp's (instanced.cuh).
template <int kAttr>
__device__ __forceinline__ void instanced_body(const Args& a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool active = i < a.n;
  float3 o = make_float3(cl::kParked * 10.0f, cl::kParked * 10.0f, cl::kParked * 10.0f);
  float3 d = make_float3(1.0f, 1.0f, 1.0f);
  float t0 = 0.0f;
  if (active) {
    o = make_float3(__ldg(a.ox + i), __ldg(a.oy + i), __ldg(a.oz + i));
    d = make_float3(__ldg(a.dx + i), __ldg(a.dy + i), __ldg(a.dz + i));
    t0 = __ldg(a.tmax + i);
  }
  InstHit h;
  instanced_sweep_warp<kAttr>(a.tables, a.inst, o, d, t0, a.t_min, a.any_hit != 0,
                              a.out_n != nullptr, active, h, a.tuv);
  if (!active) return;
  a.out_t[i] = h.code >= 0 ? h.t : __int_as_float(0x7f800000);
  a.out_code[i] = h.code;
  if (a.out_n != nullptr) {
    a.out_n[i] = h.n.x;
    a.out_n[a.n + i] = h.n.y;
    a.out_n[2 * a.n + i] = h.n.z;
    if constexpr (kAttr >= kAttrUV) {
      a.out_uv[i] = h.uv.x;
      a.out_uv[a.n + i] = h.uv.y;
    }
    if constexpr (kAttr == kAttrTan) {
      a.out_uv[2 * a.n + i] = h.tan.x;
      a.out_uv[3 * a.n + i] = h.tan.y;
      a.out_uv[4 * a.n + i] = h.tan.z;
    }
  }
}

__global__ void __launch_bounds__(kBlock) instanced_kernel(const Args a) {
  instanced_body<kAttrNormal>(a);
}

// A UV base table's closest hits with attributes: the UV planes, and the
// tangent planes (kTan).
template <bool kTan>
__global__ void __launch_bounds__(kBlock) instanced_uv_kernel(const Args a) {
  instanced_body<kTan ? kAttrTan : kAttrUV>(a);
}

}  // namespace ins

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int instanced_intersect(const ins::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n > 0) {
    const dim3 grid((a->n + ins::kBlock - 1) / ins::kBlock);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a->tuv != nullptr && a->out_n != nullptr && a->tan) {
      ins::instanced_uv_kernel<true><<<grid, ins::kBlock, 0, s>>>(*a);
    } else if (a->tuv != nullptr && a->out_n != nullptr) {
      ins::instanced_uv_kernel<false><<<grid, ins::kBlock, 0, s>>>(*a);
    } else {
      ins::instanced_kernel<<<grid, ins::kBlock, 0, s>>>(*a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* instanced_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
