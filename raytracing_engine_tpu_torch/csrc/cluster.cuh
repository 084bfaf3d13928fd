// The hierarchical cluster sweep, shared by kernel K6 (cluster.cu), the
// path tracer's kernels K4 and K5 (pt.cu) and, inside each instance, K7
// (instanced.cuh).
//
// Replaces the body of raytracing_engine_tpu/ops/pallas/cluster_intersect.py
// (cluster_sweep, :136-436): for one ray, super boxes in a near-to-far visit
// order, then each super's SUPER child boxes, then each touched cluster's
// SUBS sub-boxes, then Baldwin–Weber tests of the sub-box's 32 triangles in
// the cluster's local frame (the origin rebased to the box centre once per
// cluster). Every gate is t_near <= t_far && t_far > t_min && t_near < t.
// Closest hit keeps the first triangle of the smallest t (t < best is
// strict); any hit stops after the cluster that holds the first blocker, and
// a parked origin (|o.x| >= 1e17) counts as blocked at once (:193-201).
//
// The TPU sweep picks one visit order per tile; here each ray picks its own:
// the row of `orders` whose reference origin is nearest its origin (row 0 is
// the camera), for closest-hit sweeps with an order table; any-hit sweeps and
// sweeps without a table use `order`. So a ray's result does not depend on
// which rays share its warp, and K4, K5 and K6 agree with their plain
// versions (ops/cuda/cluster.py cluster_intersect_reference) bit for bit.
//
// Layout (ops/cuda/cluster.py sweep_tables): the TPU's (ROWS, T_pad) lane
// table is transposed once per ClusterSet into one 16-float record per
// triangle slot, [n(3), nd, r1(3), c1, r2(3), c2, mat, |n|, 0, 0] (three
// float4 loads per test), with the smooth-normal rows beside it in a
// 12-float record [s0(3), s1-s0(3), s2-s0(3), 0 x3]; each cluster gets one
// 36-float record [box(6), 0, 0, oc(3), 0, sub-box 0..3 (6 each)], so the
// sub-boxes sit beside their cluster. A UV table (ROWS_UV) adds an 8-float
// record per slot, [uv0(2), uv1-uv0(2), uv2-uv0(2), 0, 0] (rows 32-37),
// read after the sweep from the hit's slot and barycentrics (`hit_uv`),
// and with the triangle record's gradient rows the hit's texture-u tangent
// (`hit_tan`): the sweep itself is the same for every table.
//
// `sweep_warp` (K4, K5, K6, K7) is the sweep of one ray a lane, run by the
// 32 lanes of a warp together. Each lane walks its own visit order and
// applies its own gates with its own running t, so its gate decisions, and
// its result, are those of the one-ray sweep of the plain version; the
// lanes step through the hierarchy in lockstep, and a level is skipped when
// no lane's gate opens. What the warp
// shares is the sub-box test: when the gates of m <= kCoopMax lanes open on
// a step, the warp loads each requested sub-box's 32 triangle records once,
// coalesced (lane j record j), and lane j tests triangle j against each
// requesting ray in turn (the ray broadcast by __shfl_sync); a warp
// reduction keeps the smallest t and, on equal t, the lowest slot, which is
// what the serial scan's strict `tt < t` in slot order keeps (the rule that
// tests/test_torch_cluster.py::test_batched_selection_equals_sequential_scan
// holds on a set whose every triangle is duplicated, so every hit is a
// tie). With more requests each requesting lane scans its 32 records in
// order (test_sub). Measured on the H100 before this design (PERF.md §6,
// ab_config3.py --lanes on a per-thread sweep): 1.5-2.3 lanes of a warp
// test a sub-box together in K5 and 6 in K7, and m <= 8 covers 97-99% of
// K5's sub-box tests. Every table is read through the read-only path from
// global memory (config 3's 9.7 MB fit in the L2): staging the super boxes
// and cluster records in shared memory took 5-8% off K5 at config 5 only, a
// frame bound by the host's regroup, and slowed K7 (PERF.md §6).
//
// Arithmetic: NaN-propagating min/max (CUDA's fminf/fmaxf drop NaN, and the
// padding boxes are all-NaN never-hit boxes), 1/d then products for the
// slabs, a reciprocal then a product for t (two roundings, as the reference
// writes it), no FMA contraction (--fmad=false), IEEE division.
#pragma once

#include <cuda_runtime.h>

namespace cl {

constexpr int kSuper = 8;      // clusters per super-cluster
constexpr int kSubs = 4;       // sub-boxes per cluster
constexpr int kSubTris = 32;   // triangles per sub-box
constexpr int kCluster = kSubs * kSubTris;  // triangles per cluster (128)
constexpr int kTriW = 16;      // triangle record
constexpr int kSmoothW = 12;   // smooth-normal record
constexpr int kClusterW = 36;  // cluster record
constexpr int kSubOff = 12;    // first sub-box in the cluster record
constexpr int kOcOff = 8;      // cluster-local origin in the cluster record
constexpr float kParked = 1e17f;

// The tables of one ClusterSet and one frame's visit orders. Mirrored by
// ClusterTables in ops/cuda/cluster.py.
struct Tables {
  const float* sbox;     // (n_super, 8) super boxes [min(3), max(3), 0, 0]
  const float* crec;     // (C, 36) cluster records
  const float* trec;     // (T_pad, 16) triangle records
  const float* tsmooth;  // (T_pad, 12) smooth-normal records, or null (flat)
  const int* order;      // (n_super,) the visit order of any-hit sweeps
  const int* orders;     // (n_orders, n_super) per-ray closest-hit orders, or null
  const float* refs;     // (n_orders, 3) their reference origins
  int n_super, n_orders;
};

struct SweepHit {
  float t;   // t0 (the caller's t_max) when nothing was hit
  int idx;   // padded slot, -1 on a miss (0 for a parked any-hit ray)
  float u, v;  // barycentrics of the hit (smooth-normal interpolation)
};

// max/min that propagate NaN as torch.maximum / jnp.maximum do
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Slab test of box b = [min(3), max(3)] (cluster_intersect._slab_vals) and
// the sweep's gate.
__device__ __forceinline__ bool box_gate(const float* b, float3 o, float3 inv,
                                         float t_min, float t) {
  const float tx0 = (__ldg(b) - o.x) * inv.x;
  const float tx1 = (__ldg(b + 3) - o.x) * inv.x;
  const float ty0 = (__ldg(b + 1) - o.y) * inv.y;
  const float ty1 = (__ldg(b + 4) - o.y) * inv.y;
  const float tz0 = (__ldg(b + 2) - o.z) * inv.z;
  const float tz1 = (__ldg(b + 5) - o.z) * inv.z;
  const float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmin(tz0, tz1));
  const float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmax(tz0, tz1));
  return t_near <= t_far && t_far > t_min && t_near < t;
}

// The visit order of a closest-hit ray: the row whose reference is nearest
// its origin (first row on a tie).
__device__ __forceinline__ const int* ray_order(const Tables& tb, float3 o) {
  if (tb.orders == nullptr || tb.n_orders <= 0) return tb.order;
  float best = __int_as_float(0x7f800000);  // +inf
  int row = 0;
  for (int k = 0; k < tb.n_orders; ++k) {
    const float ddx = __ldg(tb.refs + 3 * k) - o.x;
    const float ddy = __ldg(tb.refs + 3 * k + 1) - o.y;
    const float ddz = __ldg(tb.refs + 3 * k + 2) - o.z;
    const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
    if (d2 < best) {
      best = d2;
      row = k;
    }
  }
  return tb.orders + row * tb.n_super;
}

// The 32 Baldwin–Weber tests of sub-box `sub` of cluster c, against the
// cluster-local origin lo (cluster_intersect.mt_sub), by one lane alone:
// sweep_warp's scan above kCoopMax requests.
__device__ __forceinline__ void test_sub(const Tables& tb, int c, int sub,
                                         float3 lo, float3 d, float t_min,
                                         SweepHit& h) {
  const int base = c * kCluster + sub * kSubTris;
  const float4* rec = reinterpret_cast<const float4*>(tb.trec) + base * (kTriW / 4);
#pragma unroll 4
  for (int j = 0; j < kSubTris; ++j, rec += kTriW / 4) {
    const float4 a = __ldg(rec);      // n, nd
    const float4 r1 = __ldg(rec + 1);  // r1, c1
    const float4 r2 = __ldg(rec + 2);  // r2, c2
    const float den = a.x * d.x + a.y * d.y + a.z * d.z;
    const float num = a.x * lo.x + a.y * lo.y + a.z * lo.z + a.w;
    const float inv = 1.0f / den;
    const float tt = -num * inv;
    const float px = lo.x + tt * d.x;  // cluster-local hit point
    const float py = lo.y + tt * d.y;
    const float pz = lo.z + tt * d.z;
    const float u = r1.x * px + r1.y * py + r1.z * pz + r1.w;
    const float v = r2.x * px + r2.y * py + r2.z * pz + r2.w;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > t_min && tt < h.t) {
      h.t = tt;
      h.idx = base + j;
      h.u = u;
      h.v = v;
    }
  }
}

// --- the warp sweep (K4, K5, K6, K7) -------------------------------------------

constexpr unsigned kFullWarp = 0xFFFFFFFFu;
// Most requests of one sub-box step that the warp tests together; above it
// each requesting lane scans its 32 records alone. Measured (PERF.md §6,
// ab_config3.py on copies of the tree): 16 against 4, 8 and 32, best for K7
// and within 1-2% of the best for K5.
constexpr int kCoopMax = 16;

__device__ __forceinline__ unsigned lane_id() {
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// The requests `req` (a lane mask) of one sub-box step, tested by the whole
// warp: for each requesting lane r in turn, lane j tests triangle j of r's
// sub-box (c, sub) against r's ray (lo, d, t_min, its running t), and the
// warp keeps the smallest t, on a tie the lowest j: test_sub's result for r,
// bit for bit. Called by all 32 lanes with the same req and sub.
__device__ __forceinline__ void test_sub_warp(const Tables& tb, unsigned req, int c, int sub,
                                              float3 lo, float3 d, float t_min, SweepHit& h) {
  const unsigned lane = lane_id();
  int loaded = -1;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r1 = a, r2 = a;
  while (req != 0u) {
    const int r = __ffs(req) - 1;
    req &= req - 1u;
    const int base = __shfl_sync(kFullWarp, c, r) * kCluster + sub * kSubTris;
    if (base != loaded) {  // warp-uniform: one coalesced load of the 32 records
      const float4* rec =
          reinterpret_cast<const float4*>(tb.trec) + (base + static_cast<int>(lane)) * (kTriW / 4);
      a = __ldg(rec);
      r1 = __ldg(rec + 1);
      r2 = __ldg(rec + 2);
      loaded = base;
    }
    const float lx = __shfl_sync(kFullWarp, lo.x, r);
    const float ly = __shfl_sync(kFullWarp, lo.y, r);
    const float lz = __shfl_sync(kFullWarp, lo.z, r);
    const float dx = __shfl_sync(kFullWarp, d.x, r);
    const float dy = __shfl_sync(kFullWarp, d.y, r);
    const float dz = __shfl_sync(kFullWarp, d.z, r);
    const float tm = __shfl_sync(kFullWarp, t_min, r);
    const float tr = __shfl_sync(kFullWarp, h.t, r);
    // test_sub's arithmetic, in its order. Each sweep keeps its own copy:
    // a helper shared by both cost 4 B more of spills, as ptxas measured it.
    const float den = a.x * dx + a.y * dy + a.z * dz;
    const float num = a.x * lx + a.y * ly + a.z * lz + a.w;
    const float inv = 1.0f / den;
    const float tt = -num * inv;
    const float px = lx + tt * dx;
    const float py = ly + tt * dy;
    const float pz = lz + tt * dz;
    const float u = r1.x * px + r1.y * py + r1.z * pz + r1.w;
    const float v = r2.x * px + r2.y * py + r2.z * pz + r2.w;
    const bool ok = u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > tm && tt < tr;
    // (t, slot) minimum over the warp; a miss is (+inf, 32). An accepted t is
    // below tr <= +inf, so it is finite and beats every miss.
    float bt = ok ? tt : __int_as_float(0x7f800000);
    int bj = ok ? static_cast<int>(lane) : kSubTris;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFullWarp, bt, off);
      const int oj = __shfl_xor_sync(kFullWarp, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    if (bj < kSubTris) {  // warp-uniform
      const float bu = __shfl_sync(kFullWarp, u, bj);
      const float bv = __shfl_sync(kFullWarp, v, bj);
      if (static_cast<int>(lane) == r) {
        h.t = bt;
        h.idx = base + bj;
        h.u = bu;
        h.v = bv;
      }
    }
  }
}

// One ray a lane against the whole set, closest hit (any_hit false) or the
// first blocker before t0 (any_hit true), for the ray of each lane whose
// `active` is set, called by all 32 lanes of the warp together (a lane
// without a ray passes active false and its h is not to be read). On return
// h.t is t0 where h.idx < 0. Any hit stops a lane after the cluster that
// holds its first blocker; a parked origin (|o.x| >= 1e17) counts as blocked
// at once (:193-201).
__device__ __forceinline__ void sweep_warp(const Tables& tb, float3 o, float3 d, float t0,
                                           float t_min, bool any_hit, bool active,
                                           SweepHit& h) {
  __syncwarp(kFullWarp);
  h.t = t0;
  h.idx = -1;
  h.u = 0.0f;
  h.v = 0.0f;
  bool live = active;
  if (any_hit && fabsf(o.x) >= kParked) {
    h.idx = 0;  // parked: its caller gates it by its own candidate mask
    live = false;
  }
  const float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  const int* order = any_hit ? tb.order : ray_order(tb, o);
  for (int si = 0; si < tb.n_super; ++si) {
    if (!__any_sync(kFullWarp, live)) break;
    const int s = __ldg(order + si);
    const bool g_super = live && box_gate(tb.sbox + s * 8, o, inv, t_min, h.t);
    if (!__any_sync(kFullWarp, g_super)) continue;
    for (int k = 0; k < kSuper; ++k) {
      const int c = s * kSuper + k;
      const float* cr = tb.crec + c * kClusterW;
      const bool g_cluster = g_super && live && box_gate(cr, o, inv, t_min, h.t);
      if (!__any_sync(kFullWarp, g_cluster)) continue;
      const float3 lo = make_float3(o.x - __ldg(cr + kOcOff), o.y - __ldg(cr + kOcOff + 1),
                                    o.z - __ldg(cr + kOcOff + 2));
      for (int sub = 0; sub < kSubs; ++sub) {
        const bool g_sub =
            g_cluster && box_gate(cr + kSubOff + 6 * sub, o, inv, t_min, h.t);
        const unsigned req = __ballot_sync(kFullWarp, g_sub);
        if (req == 0u) continue;
        if (__popc(req) <= kCoopMax) {
          test_sub_warp(tb, req, c, sub, lo, d, t_min, h);
        } else if (g_sub) {
          test_sub(tb, c, sub, lo, d, t_min, h);
        }
      }
      if (any_hit && g_cluster && h.idx >= 0) live = false;  // the any-hit stop
    }
  }
}

// Closest-hit attributes of a hit slot: the unnormalized normal (geometric,
// or interpolated on smooth tables), the material id (f32) and |n| = 2 area.
__device__ __forceinline__ void hit_attrs(const Tables& tb, const SweepHit& h,
                                          float3& n, float& mat, float& area2) {
  const float* rec = tb.trec + h.idx * kTriW;
  if (tb.tsmooth != nullptr) {
    const float* sm = tb.tsmooth + h.idx * kSmoothW;
    n = make_float3(__ldg(sm) + h.u * __ldg(sm + 3) + h.v * __ldg(sm + 6),
                    __ldg(sm + 1) + h.u * __ldg(sm + 4) + h.v * __ldg(sm + 7),
                    __ldg(sm + 2) + h.u * __ldg(sm + 5) + h.v * __ldg(sm + 8));
  } else {
    n = make_float3(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2));
  }
  mat = __ldg(rec + 12);
  area2 = __ldg(rec + 13);
}

// The texture UV of a closest hit on a UV table, from its 8-float UV record
// (T_pad, 8): uv0 + u (uv1 - uv0) + v (uv2 - uv0) at the hit's barycentrics
// (cluster_intersect.py:290-295, after the sweep: the accepted test's u, v).
__device__ __forceinline__ float2 hit_uv(const float* tuv, const SweepHit& h) {
  const float* r = tuv + h.idx * 8;
  return make_float2(__ldg(r) + h.u * __ldg(r + 2) + h.v * __ldg(r + 4),
                     __ldg(r + 1) + h.u * __ldg(r + 3) + h.v * __ldg(r + 5));
}

// The world texture-u tangent of a closest hit on a UV table (constant over
// the triangle): du1 r1 + du2 r2, the UV record's deltas times the triangle
// record's barycentric gradient rows, which rebasing to the cluster's frame
// leaves unchanged (cluster_intersect.py:297-313).
__device__ __forceinline__ float3 hit_tan(const Tables& tb, const float* tuv, const SweepHit& h) {
  const float* rec = tb.trec + h.idx * kTriW;
  const float du1 = __ldg(tuv + h.idx * 8 + 2), du2 = __ldg(tuv + h.idx * 8 + 4);
  return make_float3(du1 * __ldg(rec + 4) + du2 * __ldg(rec + 8),
                     du1 * __ldg(rec + 5) + du2 * __ldg(rec + 9),
                     du1 * __ldg(rec + 6) + du2 * __ldg(rec + 10));
}

}  // namespace cl
