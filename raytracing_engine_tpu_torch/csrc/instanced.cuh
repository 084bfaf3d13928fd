// The two-level (instanced) sweep, shared by kernel K7 (instanced.cu) and the
// path tracer's kernels K4 and K5 (pt.cu).
//
// Replaces the body of raytracing_engine_tpu/ops/pallas/instanced_intersect.py
// (instanced_sweep, :95-211): for one world-space ray, the instances of one
// base ClusterSet in the near-to-far order `iorder`; for each, a slab test of
// its world AABB with the sweep's gate, the ray moved to object space
// (o' = R^T (o - trans) * (1/s), d' = R^T d: the reciprocal first, then the
// products, as the reference rounds it), and K6's cluster sweep
// (cluster.cuh) bounded by t_w * (1/s), in the instance's own object-space
// super order (row k of `iorders`). A hit sets t_w = t_obj * s and the code
// k * t_pad + slot (an int32 here, not the TPU's f32), and with attributes
// the world normal R n. Any hit stops at the first instance that blocks; a
// parked origin (|o.x| >= 1e17) counts as blocked at once with code 0
// (:116-120), and its caller gates it by its own candidate mask.
//
// The TPU gates a whole tile per instance; here each ray gates itself, and
// the plain version (ops/cuda/instanced.py) replays exactly that, so K7, K4
// and K5 agree with it bit for bit. On a UV base table the sweep can also
// return the hit's texture UV (object-space data, carried untransformed) and
// its texture-u tangent, rotated into world space by R as the normal is
// (kAttr, :176-190). `instanced_sweep_warp` (K4, K5, K7)
// walks the instances with the 32 lanes of a warp in lockstep (every ray
// takes the same instance order and, within an instance, the same super
// order, so the lanes never part), each lane with its own gate, transform
// and running t, around cluster.cuh's sweep_warp; an instance no lane
// enters is skipped.
#pragma once

#include "cluster.cuh"

namespace ins {

constexpr int kInstW = 24;  // instance record (ops/cuda/instanced.py pack_instances)
constexpr int kBoxOff = 13;  // world AABB [min(3), max(3)] in the record
constexpr int kMatOff = 19;  // material id (f32) in the record

// The instance table of one InstancedClusters and one frame's orders.
// Mirrored by InstanceTables in ops/cuda/instanced.py.
struct Instances {
  const float* tab;    // (n, 24) [inv_rot(9), trans(3), scale, bb_min(3), bb_max(3), mat, 0 x4]
  const int* iorder;   // (n,) instance visit order
  const int* iorders;  // (n, n_super) per-instance object-space super orders
  int n, t_pad;        // instances; the base set's padded slots (code stride)
};

struct InstHit {
  float t;   // t0 (the caller's t_max) when nothing was hit
  int code;  // instance * t_pad + slot, -1 on a miss (0 for a parked any-hit ray)
  float3 n;  // unnormalized world normal of the hit (attrs), else 0
  float2 uv;   // kAttr >= kAttrUV: the texture UV of the hit (0 without one)
  float3 tan;  // kAttr == kAttrTan: its world texture-u tangent (0 without one)
};

// What a closest-hit sweep returns beside t and the code (with attrs): the
// normal; with kAttrUV also the UV from the base set's UV records; with
// kAttrTan also the tangent.
constexpr int kAttrNormal = 0;
constexpr int kAttrUV = 1;
constexpr int kAttrTan = 2;

// One world-space ray against every instance of the base set `tb`, for the
// ray of each lane whose `active` is set, called by all 32 lanes of the warp
// together (a lane without a ray passes active false and its h is not to be
// read). Any hit stops a lane at the first instance that blocks it. tuv:
// the base set's (T_pad, 8) UV records, read where kAttr >= kAttrUV (null:
// UV and tangent 0).
template <int kAttr = kAttrNormal>
__device__ __forceinline__ void instanced_sweep_warp(const cl::Tables& tb, const Instances& in,
                                                     float3 o, float3 d, float t0, float t_min,
                                                     bool any_hit, bool attrs, bool active,
                                                     InstHit& h, const float* tuv = nullptr) {
  __syncwarp(cl::kFullWarp);
  h.t = t0;
  h.code = -1;
  h.n = make_float3(0.0f, 0.0f, 0.0f);
  if constexpr (kAttr >= kAttrUV) h.uv = make_float2(0.0f, 0.0f);
  if constexpr (kAttr == kAttrTan) h.tan = make_float3(0.0f, 0.0f, 0.0f);
  bool live = active;
  if (any_hit && fabsf(o.x) >= cl::kParked) {
    h.code = 0;
    live = false;
  }
  const float3 winv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  cl::Tables tk = tb;  // each instance sweeps in its own single order
  tk.orders = nullptr;
  tk.refs = nullptr;
  tk.n_orders = 0;
  for (int ki = 0; ki < in.n; ++ki) {
    if (!__any_sync(cl::kFullWarp, live)) break;
    const int k = __ldg(in.iorder + ki);
    const float* r = in.tab + k * kInstW;
    const bool enter = live && cl::box_gate(r + kBoxOff, o, winv, t_min, h.t);
    if (!__any_sync(cl::kFullWarp, enter)) continue;
    // the transform, in the reference's rounding order
    const float r00 = __ldg(r), r01 = __ldg(r + 1), r02 = __ldg(r + 2);
    const float r10 = __ldg(r + 3), r11 = __ldg(r + 4), r12 = __ldg(r + 5);
    const float r20 = __ldg(r + 6), r21 = __ldg(r + 7), r22 = __ldg(r + 8);
    const float s = __ldg(r + 12);
    const float inv_s = 1.0f / s;
    const float sx = o.x - __ldg(r + 9), sy = o.y - __ldg(r + 10), sz = o.z - __ldg(r + 11);
    const float3 oo = make_float3((r00 * sx + r01 * sy + r02 * sz) * inv_s,
                                  (r10 * sx + r11 * sy + r12 * sz) * inv_s,
                                  (r20 * sx + r21 * sy + r22 * sz) * inv_s);
    const float3 dd = make_float3(r00 * d.x + r01 * d.y + r02 * d.z,
                                  r10 * d.x + r11 * d.y + r12 * d.z,
                                  r20 * d.x + r21 * d.y + r22 * d.z);
    tk.order = in.iorders + k * tb.n_super;
    cl::SweepHit sh;
    cl::sweep_warp(tk, oo, dd, h.t * inv_s, t_min * inv_s, any_hit, enter, sh);
    if (!enter || sh.idx < 0) continue;
    h.t = sh.t * s;
    h.code = k * in.t_pad + sh.idx;
    if (any_hit) {
      live = false;  // this lane's sweep ends
      continue;
    }
    if (attrs) {  // object normal -> world: n_w = R n (R = inv_rot^T)
      float3 n;
      float mat, area2;
      cl::hit_attrs(tk, sh, n, mat, area2);
      h.n = make_float3(r00 * n.x + r10 * n.y + r20 * n.z, r01 * n.x + r11 * n.y + r21 * n.z,
                        r02 * n.x + r12 * n.y + r22 * n.z);
      if constexpr (kAttr >= kAttrUV) {
        if (tuv != nullptr) h.uv = cl::hit_uv(tuv, sh);
      }
      if constexpr (kAttr == kAttrTan) {  // object tangent -> world, as the normal
        if (tuv != nullptr) {
          const float3 tg = cl::hit_tan(tk, tuv, sh);
          h.tan = make_float3(r00 * tg.x + r10 * tg.y + r20 * tg.z,
                              r01 * tg.x + r11 * tg.y + r21 * tg.z,
                              r02 * tg.x + r12 * tg.y + r22 * tg.z);
        }
      }
    }
  }
}

// The material id of the instance of a hit code (record column 19).
__device__ __forceinline__ float hit_material(const Instances& in, int code) {
  return __ldg(in.tab + (code / in.t_pad) * kInstW + kMatOff);
}

}  // namespace ins
