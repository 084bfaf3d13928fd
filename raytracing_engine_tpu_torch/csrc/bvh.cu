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
// Per ray the walk is exactly the plain traversal's (accel/bvh.py traverse,
// JAX accel.bvh.bvh_intersect): the same nodes in the same preorder, at most
// max_steps of them, the leaf tests in order with the strict tt < t update,
// and an any-hit ray stops after the leaf of its first hit. So K8 equals its
// plain version bit for bit.
//
// What bounds it on this card: the latency of dependent loads, not FP32
// work or bytes. A ray reads 7 floats and writes 2, and makes a few to
// hundreds of node tests (28 operations each) and some tens of triangle
// tests (57 each), and each node's address comes from the node before; a
// warp lasts as long as its longest walk. The design:
//   - one 32-byte record per node, [min(3), max(3), first * 8 + count,
//     skip] (the last two int32 bits): one sector, two float4 loads;
//   - one thread walks one ray, and it loads the records of both successors
//     of a node (node + 1 and the skip link) as soon as it has the node's
//     own, so those loads overlap the node's slab and leaf tests and the
//     next step finds its record already on the way;
//   - the tables (5.2 MB at BASELINE config 3) are read through the
//     read-only path and stay in the L2; nothing is staged in shared memory.
// Measured on the H100 against this form (PERF.md §6): a warp that
// serves the smallest cursor of its lanes on one record (2.6x slower over a
// render_pt_fast frame: the union of 32 walks is near their sum), hybrids of
// the two, 8 x 4 warp tiles of the ray grid instead of 32 consecutive rays,
// and 128-thread blocks were all slower.
//
// Arithmetic: 1/d then products for the slabs, NaN-propagating min/max
// (cluster.cuh nmin/nmax: an axis-parallel ray gives 0 * inf = NaN), IEEE
// division, no FMA contraction (--fmad=false).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

namespace bvh {

constexpr int kTraverseBlock = 256;
constexpr int kLeafSize = 4;  // accel/bvh.py LEAF_SIZE

// Launch arguments, passed by value. Mirrored field for field by
// TraverseArgs in ops/cuda/bvh_traverse.py.
struct Args {
  const float* node;     // (n_nodes, 8) [min(3), max(3), first * 8 + count, skip]
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

__global__ void __launch_bounds__(kTraverseBlock) traverse_kernel(const Args a) {
  const int i = blockIdx.x * kTraverseBlock + threadIdx.x;
  if (i >= a.n) return;
  const float ox = __ldg(a.ox + i), oy = __ldg(a.oy + i), oz = __ldg(a.oz + i);
  const float dx = __ldg(a.dx + i), dy = __ldg(a.dy + i), dz = __ldg(a.dz + i);
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float4* nodes = reinterpret_cast<const float4*>(a.node);
  const float4* tris = reinterpret_cast<const float4*>(a.tri);
  float t = __ldg(a.tmax + i);
  int idx = -1;
  int node = 0;
  const int last = a.n_nodes - 1;
  float4 b0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b1 = b0;  // the record of `node`
  if (a.n_nodes > 0) b0 = __ldg(nodes), b1 = __ldg(nodes + 1);
  for (int steps = 0; steps < a.max_steps && node < a.n_nodes; ++steps) {
    // min x, y, z, max x | max y, z, first * 8 + count, skip; the successors'
    // records (clamped into the table: a walk past the end reads neither)
    const int skip = __float_as_int(b1.w);
    const int down = min(node + 1, last), across = min(skip, last);
    const float4 d0 = __ldg(nodes + 2 * down), d1 = __ldg(nodes + 2 * down + 1);
    const float4 s0 = __ldg(nodes + 2 * across), s1 = __ldg(nodes + 2 * across + 1);
    const float tx0 = (b0.x - ox) * ix;
    const float tx1 = (b0.w - ox) * ix;
    const float ty0 = (b0.y - oy) * iy;
    const float ty1 = (b1.x - oy) * iy;
    const float tz0 = (b0.z - oz) * iz;
    const float tz1 = (b1.y - oz) * iz;
    const float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmin(tz0, tz1));
    const float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmax(tz0, tz1));
    const bool box_hit = t_near <= t_far && t_far > a.t_min && t_near < t;
    const int packed = __float_as_int(b1.z);
    const int first = packed >> 3;  // -1 at an interior node
    const bool leaf = first >= 0;
    if (box_hit && leaf) {
      const int count = packed & 7;
      for (int k = 0; k < kLeafSize && k < count; ++k) {
        const int ti = min(max(first + k, 0), a.n_tris - 1);
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
    const bool descend = box_hit && !leaf;
    node = descend ? node + 1 : skip;
    b0 = descend ? d0 : s0;
    b1 = descend ? d1 : s1;
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
    const dim3 grid((a->n + bvh::kTraverseBlock - 1) / bvh::kTraverseBlock);
    bvh::traverse_kernel<<<grid, bvh::kTraverseBlock, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
