// Device functions shared by the three cone-march kernels (conemarch.cu).
//
// Replaces the plane helpers of raytracing_engine_tpu/ops/pallas/common.py
// (ray_dir_planes, rotate_planes, sphere_sdf_plane, unrolled_sdf_caches) and
// the per-tile loops _march_tile (ops/pallas/depth.py), _shadow_march_tile
// and shade_tile_planes (ops/pallas/shade.py).
//
// One thread marches one pixel's ray. Each thread runs its own loop until its
// ray finishes, so a ray takes min(its own convergence, max_steps) steps, as
// in the masked whole-image loops of ops/march.py; a warp retires as soon as
// its 32 rays are done.
//
// Every expression follows the operation order of the plain PyTorch versions
// (ops/raygen.py, ops/march.py, ops/shade.py), and the library is built with
// --fmad=false and IEEE division and square root. The march's hit tests
// (dist <= radius, dist <= RAY_RADIUS) flip at silhouettes when one rounding
// changes, so an FMA contraction here would move whole pixels.
//
// The scene is at most 8 spheres, 8 materials and 8 lights. Every thread of a
// warp reads the same table address (a broadcast). The per-object SDF cache
// and the sphere table are indexed only by unrolled constants so that they
// stay in registers; a dynamic index would spill them to local memory. Live
// counts are read at run time and guard the unrolled loops (`if (k < n)`), so
// one build serves every scene; a dead slot is exactly the plain version's
// masked slot, which adds `big` to a min that starts at `big`.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace conemarch {

constexpr int kMaxObjects = 8;
constexpr int kMaxLights = 8;
constexpr int kMaxLevels = 16;  // pyramid levels a launch can march (RenderConfig.level_count)
// reference shaders/fragment.glsl:35-37
constexpr float kCamFallOff = 0.01f;
constexpr float kLightFallOff = 0.01f;
constexpr float kRayRadius = 0.01f;

// Launch arguments, passed by value (kernel parameters live in the constant
// bank). Mirrored field for field by Args in ops/cuda/common.py.
struct Args {
  // camera, device pointers
  const float* cam_pos;      // (3,)
  const float* cam_quat;     // (4,) [x, y, z, w]
  // the Scene's tensors, device pointers
  const float* obj_pos;      // (8, 3)
  const float* obj_radius;   // (8,)
  const int* obj_count;      // ()
  const float* mat_color;    // (8, 3)
  const float* mat_shine;    // (8,)
  const float* mat_ambient;  // (8,)
  const float* light_pos;    // (8, 3)
  const float* light_color;  // (8, 3)
  const int* light_count;    // ()
  // input image: the level before `first`, read at [y/2, x/2], for the
  // pyramid and fused kernels (nullptr: seed 1, the near plane); the finest
  // depth, read at [y, x], for the shade kernel
  const float* src;
  int src_w, src_h;
  // output: (h, w, 3) RGB of the fused and shade kernels; the pyramid
  // kernel's levels first..last, level l at out + lvl_off[l], (lvl_h[l],
  // lvl_w[l]) row-major
  float* out;
  int w, h;
  // per-level constants (RenderConfig) of the shade and fused kernels' level
  float img_sx, img_sy, ratio_x, ratio_y, threshold, render_dist;
  int max_march_steps, max_shadow_steps;
  // the pyramid kernel: levels first..last in one launch of `items` blocks,
  // one a kTileX x kTileY tile of a level, level-major; lvl_item[l] is
  // level l's first tile (ops/cuda/depth.pyramid_items). sync: the launch's
  // ticket and done counters, then a flag a tile, set to `epoch` when the
  // tile is written (ops/cuda/depth.py keeps one such buffer a stream)
  int first, last, items, epoch;
  int* sync;
  int lvl_item[kMaxLevels];
  int lvl_w[kMaxLevels];
  int lvl_h[kMaxLevels];
  int lvl_off[kMaxLevels];
  float lvl_sx[kMaxLevels];
  float lvl_sy[kMaxLevels];
  float lvl_thr[kMaxLevels];
  int device;  // CUDA ordinal the pointers and the stream belong to
};

struct Spheres {
  float x[kMaxObjects], y[kMaxObjects], z[kMaxObjects], r[kMaxObjects];
  int n;
};

__device__ __forceinline__ Spheres load_spheres(const Args& a) {
  Spheres s;
  s.n = min(max(__ldg(a.obj_count), 0), kMaxObjects);
#pragma unroll
  for (int k = 0; k < kMaxObjects; ++k) {
    s.x[k] = __ldg(a.obj_pos + 3 * k);
    s.y[k] = __ldg(a.obj_pos + 3 * k + 1);
    s.z[k] = __ldg(a.obj_pos + 3 * k + 2);
    s.r[k] = __ldg(a.obj_radius + k);
  }
  return s;
}

// sphereSDF — reference utilities.glsl:36-38
__device__ __forceinline__ float sphere_sdf(float px, float py, float pz,
                                            const Spheres& s, int k) {
  const float dx = px - s.x[k];
  const float dy = py - s.y[k];
  const float dz = pz - s.z[k];
  return sqrtf(dx * dx + dy * dy + dz * dz) - s.r[k];
}

// normalize(rotate(q, (nc.x, 1, nc.y))) with
// normCoord = ((id*2+1)*imageSize - 1)*ratio — reference compute.glsl:71-77;
// (img_sx, img_sy) is the level's imageSize
__device__ __forceinline__ float3 ray_dir_at(const Args& a, float img_sx, float img_sy,
                                             int x, int y) {
  const float ncx = ((static_cast<float>(x) * 2.0f + 1.0f) * img_sx - 1.0f) * a.ratio_x;
  const float ncy = ((static_cast<float>(y) * 2.0f + 1.0f) * img_sy - 1.0f) * a.ratio_y;
  const float qx = __ldg(a.cam_quat), qy = __ldg(a.cam_quat + 1);
  const float qz = __ldg(a.cam_quat + 2), qw = __ldg(a.cam_quat + 3);
  const float vx = ncx, vy = 1.0f, vz = ncy;
  // t = cross(q.xyz, v) + q.w*v;  r = v + 2*cross(q.xyz, t) — utilities.glsl:26-29
  const float tx = qy * vz - qz * vy + qw * vx;
  const float ty = qz * vx - qx * vz + qw * vy;
  const float tz = qx * vy - qy * vx + qw * vz;
  const float rx = vx + 2.0f * (qy * tz - qz * ty);
  const float ry = vy + 2.0f * (qz * tx - qx * tz);
  const float rz = vz + 2.0f * (qx * ty - qy * tx);
  const float n = sqrtf(rx * rx + ry * ry + rz * rz);
  return make_float3(rx / n, ry / n, rz / n);
}

__device__ __forceinline__ float3 ray_dir(const Args& a, int x, int y) {
  return ray_dir_at(a, a.img_sx, a.img_sy, x, y);
}

// Algorithm-3 cone march from o along unit d; returns the marched length.
// Per step (compute.glsl:34-68):
//   radius = (len + 1) * threshold
//   per object: cache -= last; if cache <= radius: cache = sdf(pos)
//   dist = min(big, min(cache)); last = max(dist, 0); len += last
//   if dist <= radius: len -= radius; stop
__device__ __forceinline__ float march_ray(float3 o, float3 d, float threshold,
                                           const Spheres& s, float big,
                                           int max_steps) {
  float cache[kMaxObjects];
#pragma unroll
  for (int k = 0; k < kMaxObjects; ++k) {
    cache[k] = k < s.n ? sphere_sdf(o.x, o.y, o.z, s, k) : big;
  }
  float length = 0.0f;
  float last = 0.0f;
  for (int it = 0; it < max_steps && length < big; ++it) {
    const float px = o.x + d.x * length;
    const float py = o.y + d.y * length;
    const float pz = o.z + d.z * length;
    const float radius = (length + 1.0f) * threshold;
    float dist = big;
#pragma unroll
    for (int k = 0; k < kMaxObjects; ++k) {
      if (k < s.n) {
        const float bound = cache[k] - last;
        cache[k] = bound <= radius ? sphere_sdf(px, py, pz, s, k) : bound;
        dist = fminf(dist, cache[k]);
      }
    }
    last = fmaxf(dist, 0.0f);
    length = length + last;
    if (dist <= radius) {
      length = length - radius;
      break;
    }
  }
  return length;
}

// Soft-shadow march (fragment.glsl:89-121) from o toward a light `end` away.
// Returns 0 if a step comes within RAY_RADIUS of a surface, else the running
// minimum distance (init 1), which also gates the lazy SDF cache.
__device__ __forceinline__ float shadow_ray(float3 o, float3 d, float end,
                                            const Spheres& s, int max_steps) {
  float cache[kMaxObjects];
#pragma unroll
  for (int k = 0; k < kMaxObjects; ++k) {
    cache[k] = k < s.n ? sphere_sdf(o.x, o.y, o.z, s, k) : end;
  }
  float length = 0.0f;
  float last = 0.0f;
  float nearest = 1.0f;
  for (int it = 0; it < max_steps && length < end; ++it) {
    const float px = o.x + d.x * length;
    const float py = o.y + d.y * length;
    const float pz = o.z + d.z * length;
    float dist = end;
#pragma unroll
    for (int k = 0; k < kMaxObjects; ++k) {
      if (k < s.n) {
        const float bound = cache[k] - last;
        cache[k] = bound <= nearest ? sphere_sdf(px, py, pz, s, k) : bound;
        dist = fminf(dist, cache[k]);
      }
    }
    if (dist <= kRayRadius) return 0.0f;
    last = fmaxf(dist, 0.0f);
    nearest = fminf(nearest, dist);
    length = length + last + kRayRadius;
  }
  return nearest;
}

// One pyramid-level depth from its seed: the march from the seed's point
// along d at the level's threshold, then max(seed + len, 0) (compute.glsl:86).
__device__ __forceinline__ float depth_from(const Args& a, const Spheres& s, float3 d,
                                            float seed, float threshold) {
  const float3 o = make_float3(__ldg(a.cam_pos) + d.x * seed,
                               __ldg(a.cam_pos + 1) + d.y * seed,
                               __ldg(a.cam_pos + 2) + d.z * seed);
  const float length = march_ray(o, d, threshold, s, a.render_dist, a.max_march_steps);
  return fmaxf(seed + length, 0.0f);
}

// The seed of pixel (x, y): the previous level's pixel [y/2, x/2] in src
// (compute.glsl:79-82), or 1 (the near plane) without one.
__device__ __forceinline__ float src_seed(const Args& a, int x, int y) {
  return a.src != nullptr ? __ldg(a.src + static_cast<size_t>(y >> 1) * a.src_w + (x >> 1))
                          : 1.0f;
}

// The pixel (x, y) of this thread in a launch of one-warp tiles: each warp a
// WarpX x (32 / WarpX) tile of the image, lanes row-major; a block WarpsX x
// WarpsY such tiles (kW x kH pixels), warps row-major, threadIdx.x the
// thread's index in the block. K2 and K3 both map their pixels through it.
template <int WarpX, int WarpsX, int WarpsY>
struct WarpTiles {
  static_assert(WarpX > 0 && 32 % WarpX == 0, "a warp's tile is 32 pixels");
  static constexpr int kWarpY = 32 / WarpX;
  static constexpr int kThreads = 32 * WarpsX * WarpsY;
  static constexpr int kW = WarpX * WarpsX;  // a block's tile, in pixels
  static constexpr int kH = kWarpY * WarpsY;

  __device__ __forceinline__ static int2 pixel() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return make_int2(blockIdx.x * kW + (warp % WarpsX) * WarpX + lane % WarpX,
                     blockIdx.y * kH + (warp / WarpsX) * kWarpY + lane / WarpX);
  }

  static dim3 grid(int w, int h) { return dim3((w + kW - 1) / kW, (h + kH - 1) / kH); }
};

// Phong shading with soft shadows of one pixel at `depth` along d
// (fragment.glsl:127-187). Shared by the shade and the fused kernel, which
// are therefore equal bit for bit.
__device__ __forceinline__ float3 shade_pixel(const Args& a, const Spheres& s,
                                              float3 d, float depth) {
  if (!(depth < a.render_dist)) return make_float3(0.0f, 0.0f, 0.0f);  // :137-140
  const float cx = __ldg(a.cam_pos), cy = __ldg(a.cam_pos + 1), cz = __ldg(a.cam_pos + 2);
  const float px = cx + d.x * depth;
  const float py = cy + d.y * depth;
  const float pz = cz + d.z * depth;

  // nearest object, first minimum; material i pairs with object i (:144-156)
  int nearest = 0;
  float best = INFINITY;
  float ox = s.x[0], oy = s.y[0], oz = s.z[0];
#pragma unroll
  for (int k = 0; k < kMaxObjects; ++k) {
    if (k < s.n) {
      const float dk = sphere_sdf(px, py, pz, s, k);
      if (dk < best) {
        best = dk;
        nearest = k;
        ox = s.x[k];
        oy = s.y[k];
        oz = s.z[k];
      }
    }
  }
  const float mr = __ldg(a.mat_color + 3 * nearest);
  const float mg = __ldg(a.mat_color + 3 * nearest + 1);
  const float mb = __ldg(a.mat_color + 3 * nearest + 2);
  const float shine = __ldg(a.mat_shine + nearest);
  const float amb = __ldg(a.mat_ambient + nearest);

  // camera falloff (:162-163)
  const float tcx = px - cx, tcy = py - cy, tcz = pz - cz;
  const float cam_dist = sqrtf(tcx * tcx + tcy * tcy + tcz * tcz);
  const float cam_fall = fmaxf(kCamFallOff * (cam_dist * cam_dist + 1.0f), 1.0f);

  // normal and its falloff (:166-167)
  float nx = px - ox, ny = py - oy, nz = pz - oz;
  const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
  nx = nx / nlen;
  ny = ny / nlen;
  nz = nz / nlen;
  const float normal_fall = fmaxf(nx * -d.x + ny * -d.y + nz * -d.z, 0.0f);

  const int n_light = min(max(__ldg(a.light_count), 0), kMaxLights);
  float r = 0.0f, g = 0.0f, b = 0.0f;
#pragma unroll 1
  for (int l = 0; l < n_light; ++l) {
    const float tlx = __ldg(a.light_pos + 3 * l) - px;
    const float tly = __ldg(a.light_pos + 3 * l + 1) - py;
    const float tlz = __ldg(a.light_pos + 3 * l + 2) - pz;
    const float light_dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float3 ld = make_float3(tlx / light_dist, tly / light_dist, tlz / light_dist);

    // the shadow march starts 1.0 along the light direction (:176)
    const float3 so = make_float3(px + ld.x, py + ld.y, pz + ld.z);
    const float soft = fminf(shadow_ray(so, ld, light_dist, s, a.max_shadow_steps), 1.0f);

    const float light_fall = fmaxf(kLightFallOff * light_dist * light_dist, 1.0f);
    const float diffuse = fmaxf(nx * ld.x + ny * ld.y + nz * ld.z, 0.0f);
    // reflect(-l, n) = -l - 2*dot(n, -l)*n
    const float dln = nx * -ld.x + ny * -ld.y + nz * -ld.z;
    const float rx = -ld.x - 2.0f * dln * nx;
    const float ry = -ld.y - 2.0f * dln * ny;
    const float rz = -ld.z - 2.0f * dln * nz;
    const float base = fmaxf(rx * -d.x + ry * -d.y + rz * -d.z, 0.0f);
    const float spec = fmaxf(diffuse * powf(base, shine), 0.0f);
    const float lit = fmaxf(diffuse + spec, 0.0f);

    r = r + (amb + lit * __ldg(a.light_color + 3 * l) / light_fall * soft) / cam_fall * normal_fall * mr;
    g = g + (amb + lit * __ldg(a.light_color + 3 * l + 1) / light_fall * soft) / cam_fall * normal_fall * mg;
    b = b + (amb + lit * __ldg(a.light_color + 3 * l + 2) / light_fall * soft) / cam_fall * normal_fall * mb;
  }
  return make_float3(r, g, b);
}

}  // namespace conemarch
