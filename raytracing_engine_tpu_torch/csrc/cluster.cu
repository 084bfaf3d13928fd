// Kernel K6, the cluster intersector, for Hopper (sm_90a), and its C entry
// point (bound with ctypes by ops/cuda/cluster.py and ops/cuda/common.py).
//
// Replaces raytracing_engine_tpu/ops/pallas/cluster_intersect.py:
// _cluster_kernel (K6, launched by cluster_intersect): closest or any hit of
// a grid of rays against a ClusterSet, with the closest hit's attributes
// (normal, material, area, and on a UV table the texture UV and, on
// request, the texture-u tangent) on request. The sweep itself is
// cluster.cuh. The UV planes come from a second instantiation (kUV), the
// tangent planes from a third (cluster_kernel<true, true>: normal maps and
// mip LOD), so a table without UVs runs the kernel it ran before.
//
// What bounds it on this card: FP32 ALU work and divergence, not bytes. A
// ray reads 3 + 6 + 3 + 1 floats and writes 2 (7 with attributes), while it
// runs tens of box tests (28 operations each) and hundreds of triangle tests
// (30 each) against tables that stay in the L2. So: one ray a lane, and the
// warp sweeps its 32 rays together (cluster.cuh sweep_warp, as K4, K5 and
// K7 do): each lane's gates decide for its own ray, and a sub-box that a few
// lanes open is loaded once, coalesced, and tested by the whole warp, where
// a lane sweeping alone would scan its 32 triangles serially while the other
// lanes of the warp wait. The tables are read through the read-only path,
// nothing is staged in shared memory (the set is 9.7 MB at BASELINE config
// 3).
//
// Block: kClusterBlock threads over consecutive rays, in flat order (K6
// takes ray planes of any shape); a lane past the last ray sweeps with
// active false and writes nothing, so every warp reaches the sweep's
// shuffles whole.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
#include "cluster.cuh"

namespace cl {

// Measured on the H100 against 128, with kCoopMax 8, 16 and 32 (PERF.md §6,
// ab_config3.py --k6-worker).
constexpr int kClusterBlock = 256;

// Launch arguments, passed by value. Mirrored field for field by ClusterArgs
// in ops/cuda/cluster.py.
struct Args {
  Tables tables;
  const float* ox;   // (n,) ray origins and directions, one plane each
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tmax;  // (n,) initial t (the any-hit cutoff)
  float* out_t;       // (n,) t of the hit, +inf on a miss
  int* out_idx;       // (n,) padded slot, -1 on a miss
  float* out_attr;    // (5, n) nx, ny, nz, mat, area (7 with u, v: kUV; 10 with
                      // tx, ty, tz: kTan), or null
  int n;
  float t_min;
  int any_hit;
  int device;        // CUDA ordinal the pointers and the stream belong to
  const float* tuv;  // (T_pad, 8) UV records of a UV table, or null
  int tan;           // with tuv and out_attr: also the tangent planes
};

// The kernel's body: kUV adds the UV planes, kTan the tangent planes after
// them.
template <bool kUV, bool kTan>
__device__ __forceinline__ void cluster_body(const Args& a) {
  const int i = blockIdx.x * kClusterBlock + threadIdx.x;
  const bool active = i < a.n;
  const int j = active ? i : a.n - 1;  // a lane past the end sweeps the last ray, inactive
  const float3 o = make_float3(__ldg(a.ox + j), __ldg(a.oy + j), __ldg(a.oz + j));
  const float3 d = make_float3(__ldg(a.dx + j), __ldg(a.dy + j), __ldg(a.dz + j));
  SweepHit h;
  sweep_warp(a.tables, o, d, __ldg(a.tmax + j), a.t_min, a.any_hit != 0, active, h);
  if (!active) return;
  a.out_t[i] = h.idx >= 0 ? h.t : __int_as_float(0x7f800000);
  a.out_idx[i] = h.idx;
  if (a.out_attr != nullptr) {
    float3 nrm = make_float3(0.0f, 0.0f, 0.0f);
    float mat = 0.0f, area2 = 0.0f;
    if (h.idx >= 0) hit_attrs(a.tables, h, nrm, mat, area2);
    a.out_attr[i] = nrm.x;
    a.out_attr[a.n + i] = nrm.y;
    a.out_attr[2 * a.n + i] = nrm.z;
    a.out_attr[3 * a.n + i] = mat;
    a.out_attr[4 * a.n + i] = area2 * 0.5f;  // |cross| / 2 = triangle area
    if constexpr (kUV) {
      const float2 uv = h.idx >= 0 ? hit_uv(a.tuv, h) : make_float2(0.0f, 0.0f);
      a.out_attr[5 * a.n + i] = uv.x;
      a.out_attr[6 * a.n + i] = uv.y;
    }
    if constexpr (kTan) {
      const float3 tg = h.idx >= 0 ? hit_tan(a.tables, a.tuv, h) : make_float3(0.0f, 0.0f, 0.0f);
      a.out_attr[7 * a.n + i] = tg.x;
      a.out_attr[8 * a.n + i] = tg.y;
      a.out_attr[9 * a.n + i] = tg.z;
    }
  }
}

template <bool kUV>
__global__ void __launch_bounds__(kClusterBlock) cluster_kernel(const Args a) {
  cluster_body<kUV, false>(a);
}

// The third instantiation, an overload, so the two above keep their names.
template <bool kUV, bool kTan>
__global__ void __launch_bounds__(kClusterBlock) cluster_kernel(const Args a) {
  cluster_body<kUV, kTan>(a);
}

}  // namespace cl

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int cluster_intersect(const cl::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n > 0) {
    const dim3 grid((a->n + cl::kClusterBlock - 1) / cl::kClusterBlock);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a->tuv != nullptr && a->out_attr != nullptr && a->tan) {
      cl::cluster_kernel<true, true><<<grid, cl::kClusterBlock, 0, s>>>(*a);
    } else if (a->tuv != nullptr && a->out_attr != nullptr) {
      cl::cluster_kernel<true><<<grid, cl::kClusterBlock, 0, s>>>(*a);
    } else {
      cl::cluster_kernel<false><<<grid, cl::kClusterBlock, 0, s>>>(*a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
