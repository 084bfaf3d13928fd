// Kernel K8, the skip-link BVH traversal, for Hopper (sm_90a), and its C
// entry point (bound with ctypes by ops/cuda/bvh_traverse.py and
// ops/cuda/common.py).
//
// Replaces raytracing_engine_tpu/ops/pallas/bvh_traverse.py:_traverse_kernel
// (launched by bvh_intersect_packet): closest or any hit of a grid of rays
// against accel/bvh.py's stackless BVH (nodes in DFS preorder, node+1 on a
// hit of an interior box, the skip link otherwise), Möller-Trumbore over the
// <= LEAF_SIZE triangles of a leaf.
//
// The TPU walks one scalar node cursor per ray tile, because per-lane
// pointer chasing is what its vector unit cannot do. Here each thread walks
// its own cursor, which is what a GPU thread does well: per ray the walk is
// exactly the plain traversal's (accel/bvh.py traverse, JAX accel.bvh.
// bvh_intersect): the same nodes in the same preorder, at most max_steps of
// them, the leaf tests in order with the strict tt < t update, and an
// any-hit ray stops after the leaf of its first hit. So K8 equals its plain
// version bit for bit.
//
// What bounds it on this card: divergence and dependent loads, not FP32
// work or bytes. A ray reads 7 floats and writes 2, and makes tens to
// hundreds of node tests (28 operations each) and some tens of triangle
// tests (57 each) whose next address depends on the last. So: one thread per
// ray, a warp runs the union of its rays' walks, the tables (a 32-byte box
// record and a 16-byte link record per node, a 48-byte record per triangle:
// 5.6 MB at BASELINE config 3) are read through the read-only path and stay
// in the L2; nothing is staged in shared memory.
//
// Arithmetic: 1/d then products for the slabs, NaN-propagating min/max
// (cluster.cuh nmin/nmax: an axis-parallel ray gives 0 * inf = NaN), IEEE
// division, no FMA contraction (--fmad=false).
//
// Block: 128 threads over consecutive rays; the ragged end is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

namespace bvh {

constexpr int kBlock = 128;
constexpr int kLeafSize = 4;  // accel/bvh.py LEAF_SIZE

// Launch arguments, passed by value. Mirrored field for field by
// TraverseArgs in ops/cuda/bvh_traverse.py.
struct Args {
  const float* node_bb;  // (n_nodes, 8) [min(3), max(3), 0, 0]
  const int* node_meta;  // (n_nodes, 4) [first_tri, tri_count, skip, 0]
  const float* tri;      // (n_tris, 12) [v0(3), e1(3), e2(3), 0 x3]
  const float* ox;       // (n,) ray origins and directions, one plane each
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tmax;     // (n,) initial t (the any-hit cutoff)
  float* out_t;          // (n,) t of the hit, +inf on a miss
  int* out_idx;          // (n,) reordered triangle index, -1 on a miss
  int n, n_nodes, n_tris;
  float t_min;
  int any_hit, max_steps;
  int device;            // CUDA ordinal the pointers and the stream belong to
};

// max/min that propagate NaN as torch.maximum / jnp.maximum do
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kBlock) traverse_kernel(const Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const float ox = __ldg(a.ox + i), oy = __ldg(a.oy + i), oz = __ldg(a.oz + i);
  const float dx = __ldg(a.dx + i), dy = __ldg(a.dy + i), dz = __ldg(a.dz + i);
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float4* boxes = reinterpret_cast<const float4*>(a.node_bb);
  const int4* links = reinterpret_cast<const int4*>(a.node_meta);
  const float4* tris = reinterpret_cast<const float4*>(a.tri);
  float t = __ldg(a.tmax + i);
  int idx = -1;
  int node = 0;
  for (int steps = 0; steps < a.max_steps && node < a.n_nodes; ++steps) {
    const float4 b0 = __ldg(boxes + 2 * node);      // min x, y, z, max x
    const float4 b1 = __ldg(boxes + 2 * node + 1);  // max y, z
    const float tx0 = (b0.x - ox) * ix;
    const float tx1 = (b0.w - ox) * ix;
    const float ty0 = (b0.y - oy) * iy;
    const float ty1 = (b1.x - oy) * iy;
    const float tz0 = (b0.z - oz) * iz;
    const float tz1 = (b1.y - oz) * iz;
    const float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmin(tz0, tz1));
    const float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmax(tz0, tz1));
    const bool box_hit = t_near <= t_far && t_far > a.t_min && t_near < t;
    const int4 link = __ldg(links + node);  // first, count, skip
    const bool leaf = link.x >= 0;
    if (box_hit && leaf) {
      for (int k = 0; k < kLeafSize && k < link.y; ++k) {
        const int ti = min(max(link.x + k, 0), a.n_tris - 1);
        const float4 r0 = __ldg(tris + 3 * ti);      // v0, e1.x
        const float4 r1 = __ldg(tris + 3 * ti + 1);  // e1.y, e1.z, e2.x, e2.y
        const float4 r2 = __ldg(tris + 3 * ti + 2);  // e2.z
        const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
        const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
        const float px = dy * e2z - dz * e2y;  // pvec = d x e2
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv = 1.0f / (fabsf(det) < 1e-9f ? 1.0f : det);
        const float tvx = ox - r0.x, tvy = oy - r0.y, tvz = oz - r0.z;
        const float u = (tvx * px + tvy * py + tvz * pz) * inv;
        const float qx = tvy * e1z - tvz * e1y;  // qvec = tvec x e1
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
        if (fabsf(det) >= 1e-9f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            tt > a.t_min && tt < t) {
          t = tt;
          idx = ti;
        }
      }
    }
    if (a.any_hit && idx >= 0) break;  // a confirmed hit ends an any-hit walk
    node = (box_hit && !leaf) ? node + 1 : link.z;
  }
  a.out_t[i] = idx >= 0 ? t : __int_as_float(0x7f800000);
  a.out_idx[i] = idx;
}

}  // namespace bvh

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int bvh_traverse(const bvh::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n > 0) {
    const dim3 grid((a->n + bvh::kBlock - 1) / bvh::kBlock);
    bvh::traverse_kernel<<<grid, bvh::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
