// Device functions of the path tracer (kernels K4 and K5, pt.cu).
//
// Replaces the per-tile body of raytracing_engine_tpu/ops/pallas/pt_kernel.py
// (_pt_kernel and _pt_rebin_kernel -> pathtracer/wavefront.py _trace_core):
// camera rays, the unrolled sphere and triangle intersection, the cluster
// sweep of a mesh (cluster.cuh) or the two-level sweep of an instanced mesh
// (instanced.cuh: materials per instance, light area 1 for its hits, as
// wavefront.py:397-488), NEE toward the light table with
// power-heuristic MIS, DIFFUSE / MIRROR / smooth DIELECTRIC scattering,
// Russian roulette, and the PCG4D stream keyed on global pixel coordinates
// (ops/rng_pcg.py); and, in the material instantiation (kMat), the optional
// material features of JAX's static flags (pt_kernel.py:200-206, :707-713):
// the GGX METAL branch (isotropic, or anisotropic in the per-normal frame),
// GGX rough glass (Walter 2007), checkers in world or UV space, image
// textures from the atlas (nearest or bilinear) at the hit's UV (spheres'
// analytic UVs, the unrolled slots' tri_uv, a UV ClusterSet's rows), spectral
// dispersion (the `chan` state), the gradient sky read by escaped rays, and
// the equirect env map: read by escaped rays under MIS and alias-sampled by
// NEE against the light table with one coin. The atlas and the env map's
// tables (at most 3 x 32 x 128 floats each) are read from global memory
// through the read-only path. A third instantiation (kTex) adds the texture
// features that read the hit's texture-u tangent or a UV table under
// instances: tangent-space normal maps (the frame from the tangent,
// wavefront._perturb_normal), the albedo mip chains' trilinear filter at the
// ray cone's footprint (wavefront._mip_lod_footprint, _sample_rect_tri; the
// cone's path length `tacc` rides in the ray state), and instances of a UV
// ClusterSet (instanced.cuh kAttrTan). A fourth template flag (kSamp, in
// every instantiation's sampling form) adds the sampling features: the thin
// lens (thin_lens_ray) and the R_d sampler (draw_r2: the camera dimensions,
// and bounce 0's NEE dimensions) in `camera_ray` and `bounce`; K4's adaptive
// passes in pt_body.cuh. A fifth (kLights, in the light forms of
// pt_lights.cu, which take the sampling features too) adds the light
// features, each under its run-time flag (their state in `Lights`):
// homogeneous fog and single-scatter media (fog_segment: Beer–Lambert and
// the fog color's in-scatter, the equiangular scatter vertex with its own
// shadow ray, and the shadow segments' transmittance), the light tree
// (tree_walk, and the hit's slot match for its MIS density), and mesh
// lights, one triangle a pass (a row of Args.mesh_rows) or one a lane (the
// alias tables Args.mlt_*), with the bounce's longer draw (JAX's nu). Their
// branches sit under `if constexpr (kLights)` or behind a test of kLights,
// so the instantiations without them keep their code and their registers
// (their state is in `Lights`, not in `Scene` or `Hit`, whose layouts those
// instantiations keep).
//
// One thread follows one ray. The body of one bounce is one function,
// `bounce`, over a per-ray state (`Ray`, the 17 planes of
// wavefront.pack_state, 18 with a dispersive scene's chan): K4 loops it
// over the bounces of every pass in registers, K5 runs one bounce per launch
// on the state it reads back, so K5 equals K4 by construction. `bounce`, `intersect` and `occluded` are
// templates on the mesh kind (kMesh*: a constant in each of K4's
// instantiations, so each holds only its own sweep; kMeshAny in K5, whose
// tables pick it at run time) and on the form: one thread alone (kWarp
// false, scenes without a mesh: a ray that misses or dies stops at once) or
// the warp's lanes together (kWarp true: a mesh is swept by cluster.cuh
// sweep_warp or instanced.cuh instanced_sweep_warp). In the warp form every
// lane of the warp calls `bounce`, a lane without a live ray with live
// false, and the body reaches both sweeps on every lane (a lane that missed
// or casts no shadow ray enters them inactive) and parks a miss only after
// the shadow sweep. The warp sweeps equal the plain sweep bit for bit per
// ray, so K5 equals K4. `bounce` is also a template on kMat: false, the
// program of the scenes without the material features, unchanged; true,
// the same body with the features' branches, each taken at run time from
// the scene's flags (uniform across a launch) exactly where the plain
// version's static gate puts it, so a scene with none of them renders the
// same in both. The material instantiation keeps the metal-free NEE form
// when the scene has no metal, as the JAX package does.
//
// Every expression keeps the operation order of the plain PyTorch version
// (pathtracer/wavefront.py), and the library builds with --fmad=false and
// IEEE division and square root, so the two agree bit for bit where the
// math library does: a branch decision (u < refl_p, t < best_t, the CDF
// walk) flips when one rounding changes, and then the whole path differs.
//
// Where the plain version computes a value on every lane and selects, this
// code computes it only on the lanes that keep it; where a dead lane's work
// adds exactly 0, this code stops: a ray that misses or dies is parked
// (origin 1e18, as the plain version parks it) and does no more work. The
// BIG = 3.4e38 and 1e18 sentinels rely on IEEE semantics (no fast math).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "instanced.cuh"

namespace pt {

constexpr float kBig = 3.4e38f;
// f32 roundings of the double constants the plain version multiplies by
constexpr float kPi = 3.1415927410125732f;
constexpr float kTwoPi = 6.2831854820251465f;
constexpr float kFourPi = 12.566370964050293f;
constexpr float kInvPi = 0.31830987334251404f;  // f32(1 / pi)
constexpr float kHalfPi = 0x1.921fb6p+0f;       // f32(0.5 * pi)
constexpr float kHalfInvPi = 0x1.45f306p-3f;    // f32(0.5 / pi)
constexpr float kTwoPiPi = 0x1.3bd3ccp+4f;      // f32(2 pi pi)
constexpr float kBelowOne = 0x1.fffffcp-1f;     // f32(1 - 1e-7)
constexpr int kTexW = 128;                      // texels per atlas / env-map row
constexpr int kDiffuse = 0;
constexpr int kMirror = 1;
constexpr int kDielectric = 3;
constexpr int kMetal = 4;
constexpr int kLightTri = 1;
constexpr int kLightMesh = 2;  // the mesh lights' pseudo-slot
constexpr uint32_t kPassPrime = 0x9E3779B9u;  // int32 -1640531527

// Packed scene table widths (ops/cuda/pt.py pack_pt_scene):
//   sphere   [pos(3), radius, mat, 0, 0, 0]
//   triangle [v0(3), e1(3), e2(3), mat, 0, 0]
//   material [albedo(3), emission(3), kind, ior] and, in the material
//            instantiation, the optional columns in JAX's fixed order:
//            [albedo2(3), checker scale] | rough | rough2 | dispersion,
//            zero-padded to a multiple of 4 (Args.mat_w: 8, 12 or 16)
//            (the material instantiation's full order: [albedo2(3), scale]
//            | tex_space | tex_rect(4) | rough | rough2 | dispersion, width
//            8 to 20; the texture instantiation's: [albedo2(3), scale] |
//            tex_space | tex_rect(4) | mips(4 L) | nrm_rect(4), nrm_scale |
//            rough | rough2 | dispersion)
//   light    [kind, prim, area, le(3), pick, cdf, total_power, 0, 0, 0]
//   env      [bottom(3), 0, top(3), 0] (the gradient sky; Args.sky)
//   tri uv   [u0, v0, u1, v1, u2, v2, 0, 0] per unrolled slot (Args.tri_uvs)
//   atlas, env map: (3K, 128) channel-major rows, row c K + k (Args.atlas,
//            Args.env_img; env_smp's three blocks are p_sel, alias
//            probability and alias index)
constexpr int kSphW = 8;
constexpr int kTriW = 12;
constexpr int kMatW = 8;
constexpr int kLightW = 12;
constexpr int kEnvW = 8;
constexpr int kTriUnrollMax = 32;
constexpr int kTreeW = 8;      // light tree cluster row [center(3), radius, power, 0, 0, 0]
constexpr int kPassRowW = 16;  // mesh-light row [v0(3), e1(3), e2(3), Le(3), area, pick, 0, 0]
constexpr float kDeadO = 1e18f;                    // parked-ray origin
constexpr float kInvSqrt3 = 0.57735025882720947f;  // its direction components
constexpr int kStatePlanes = 17;  // then chan (a dispersive scene) and tacc (Args.tacc)
constexpr float kQuarterInvPi = static_cast<float>(0.25 / 3.141592653589793);  // f32(0.25 / pi)

// Mesh kinds, one instantiation of K4 each (pt_render picks it from the
// tables, as stage_scene reads them: cl.trec, then inst.tab, null or not;
// ops/cuda/pt.py MESH_KINDS names them in this order); K5 takes kMeshAny,
// the kind its tables name.
constexpr int kMeshNone = 0;       // spheres and up to kTriUnrollMax unrolled triangles
constexpr int kMeshClusters = 1;   // and a mesh as a ClusterSet (Args.cl)
constexpr int kMeshInstances = 2;  // and instances of that mesh (Args.inst)
constexpr int kMeshAny = -1;

// Launch arguments, passed by value. Mirrored field for field by PTArgs in
// ops/cuda/pt.py.
struct Args {
  const float* cam_pos;    // (3,)
  const float* cam_quat;   // (4,) [x, y, z, w]
  const float* sph;        // (S, 8)
  const float* tri;        // (T, 12)
  const float* mat;        // (M, 8)
  const float* light;      // (L, 12)
  const int* counts;       // (4,): live spheres, triangles, materials, lights
  float* out;              // K4: (h, w, 3), the mean radiance of the band
  unsigned long long* nrays;  // (1,): rays traced, added to
  int S, T, M, L;          // table rows (padded)
  int width, height;       // the full image (the camera's projection)
  int w, h, row0;          // the band rendered: rows row0 .. row0 + h - 1
  int spp, seed, spp_offset;  // pass s uses seed + (spp_offset + s) * prime
  int max_bounces, rr_start, use_nee, uniform_lights;
  float ratio_x, ratio_y, t_min, eps;
  cl::Tables cl;           // a mesh as a ClusterSet (cl.trec null: none)
  ins::Instances inst;     // instances of cl's mesh (inst.tab null: none)
  float* state;            // K5: (17 or 18, n_state) ray state, updated in place
  int n_state, bounce;     // K5: rays in the state, the bounce this launch runs
  int device;              // CUDA ordinal the pointers and the stream belong to
  // The material features, after every field the instantiations without them
  // read, so those keep their parameter offsets. material (0 / 1) picks the
  // instantiation: ops/cuda/pt.py sets it from PTScene.has_material_features.
  const float* env;        // (2, 4) gradient sky (sky != 0), else null
  int mat_w;               // material table width: 8 to 20
  int material;
  int metal, aniso, texture, dispersion, sky;  // the features (0 / 1)
  // The features added after them (0 / 1), then their tables: rough glass,
  // the env map, UV-space checkers, image textures, the unrolled slots' UVs,
  // bilinear filtering (PTConfig.tex_filter)
  int rough_diel, env_map, uv_space, image, tri_uv, bilinear;
  const float* env_img;    // (3 env_k, 128) radiance rows (env_map)
  const float* env_smp;    // (3 env_k, 128) [p_sel; alias prob; alias index] rows
  const float* env_pick;   // (1,) the probability that NEE samples the map
  int env_k;
  const float* atlas;      // (3 atlas_k, 128) texture atlas (image)
  int atlas_k;
  const float* tri_uvs;    // (T, 8) the unrolled slots' UVs (tri_uv)
  const float* cl_uv;      // (T_pad, 8) the UV records of a UV ClusterSet (or base set), or null
  // The texture instantiation (tex 0 / 1, ops/cuda/pt.py
  // uses_tex_instantiation) and its features: normal maps, the mip chains'
  // L levels (0: none), the trilinear filter's ray cone (tacc 0 / 1: the
  // state's tacc plane) and its spread 2 fov / width
  int tex, normal_map, n_mips, tacc;
  float lod_alpha;
  // The sampling instantiation (samp 0 / 1, pt.cu kSamp: ops/cuda/pt.py
  // sets it where any of these is on) and its features: the thin lens
  // (aperture > 0: its radius, and the focus plane's distance), the R_d
  // sampler (r2 0 / 1: the camera dimensions, and bounce 0's NEE dimensions
  // under use_nee, keyed on the base seed and the global pass), and K4's
  // adaptive passes (active non-null: one pass a launch, spp 1; a pixel
  // traces only while its cell's flag is set; cells cell_h x cell_w, grid_w
  // a row)
  int samp;
  float aperture, focus_dist;
  int r2;
  const int* active;
  int cell_h, cell_w, grid_w;
  // The light features (the light forms of pt_lights.cu, kLights, which
  // ops/cuda/pt.py launches where any is on): homogeneous fog (fog_density > 0) and its
  // in-scatter color, single scattering (fog_scatter > 0); the light tree
  // (tree 0 / 1: light_sampling "tree"; the slot columns ride the light
  // table's columns 9-11) and its n_clusters rows (C, 8); mesh lights per
  // pass (mesh_rows: (n, 16) rows, row s for pass s of a K4 launch, K5's
  // pass's row first) or per lane (mlt_k: the lane tables' K, 0 without;
  // mlt_meta [total area, pick])
  float fog_density, fog_scatter, fog_r, fog_g, fog_b;
  int tree, n_clusters;
  const float* lt;
  const float* mesh_rows;
  const float* mlt_rows;   // (12 mlt_k, 128) [v0, e1, e2, Le] component rows
  const float* mlt_smp;    // (2 mlt_k, 128) [alias prob; alias index] rows
  const float* mlt_meta;
  int mlt_k;
};

// The cell update after each adaptive pass of K4 (pt_cell_kernel, pt.cu).
// Mirrored field for field by AdaptArgs in ops/cuda/pt.py.
struct AdaptArgs {
  const float* rad;  // (h, w, 3): the pass's radiance, K4's output at spp 1
  float* acc;        // (h, w, 3): the sum of the passes taken
  float* mean;       // (h, w): each pixel's Welford mean of the luminance
  float* m2;         // (h, w): and its sum of squared deviations
  int* active;       // (n_cells,): 1 while the cell takes passes
  float* taken;      // (n_cells,): the passes the cell took
  float* out;        // (h, w, 3): acc / taken, written when the cell stops
  float* scratch;    // (n_cells, 2, half): the cells' pairwise sums
  int w, cell_h, cell_w, grid_w, n_cells;
  int half;          // half the cell's pixel count rounded up to a power of 2
  int s, min_spp, spp;  // passes taken after this one; the floor and budget
  float tol;
  int device;
};

// The scene tables, in shared memory, the live counts and the mesh.
struct Scene {
  const float* sph;
  const float* tri;
  const float* mat;
  const float* light;
  const float* env;  // the sky's 8 floats (sky), else unused
  int S, T, M, L;
  int n_sph, n_tri, n_light;
  float total_power;
  // the material features and their columns in the material table (kMat)
  int mat_w;
  bool metal, aniso, texture, dispersion, sky;
  bool rough_diel, env_map, uv_space, image, tri_uv, bilinear;
  bool needs_uv;  // shading reads hit UVs: UV-space checkers or images
  int c_tex, c_space, c_rect, c_rough, c_rough2, c_disp;
  const float* env_img;
  const float* env_smp;
  float env_pick;
  int env_k;
  const float* atlas;
  int atlas_k;
  const float* tri_uvs;
  const float* cl_uv;
  // the texture features (kTex) and their columns
  bool normal_map, tacc;
  int n_mips, c_mips, c_nrm;
  float lod_alpha;
  cl::Tables cl;
  ins::Instances inst;
  bool mesh;       // kMeshAny: intersect cl instead of the unrolled triangle slots
  bool instanced;  // kMeshAny: intersect the instances of cl instead
};

// The light features' flags and tables (kLights, pt_body.cuh stage_lights):
// fog and media, the light tree, mesh lights per lane (per pass: the pass's
// row, an argument of bounce). A struct of its own, so that Scene, and with
// it the instantiations without these features, keeps its layout.
struct Lights {
  bool fog, media, tree, lane_mesh;
  float fog_density, fog_scatter;
  float3 fog_color;
  int n_clusters;
  const float* lt;
  const float* mlt_rows;
  const float* mlt_smp;
  int mlt_k;
  float mesh_area, mesh_pick;
};

// A light sample's light-feature inputs (kLights): the pass's mesh-light
// row (or null), the point the light tree weighs its clusters at (null: no
// tree), and the lane mesh light's triangle dimension.
struct LightArgs {
  const float* mesh_row;
  const float3* tree_p;
  float u_tri;
};

// Whether a scene of kind kMesh sweeps instances, else a ClusterSet: a
// constant in K4's instantiations, read from the scene in K5's (kMeshAny,
// where sc.mesh also holds with instances: has_clusters is read only where
// has_instances is false).
template <int kMesh>
__device__ __forceinline__ bool has_instances(const Scene& sc) {
  return kMesh == kMeshAny ? sc.instanced : kMesh == kMeshInstances;
}
template <int kMesh>
__device__ __forceinline__ bool has_clusters(const Scene& sc) {
  return kMesh == kMeshAny ? sc.mesh : kMesh == kMeshClusters;
}

// max/min that propagate NaN as torch.maximum / torch.clamp do
__device__ __forceinline__ float vmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return make_float3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 scale3(float3 a, float s) {
  return make_float3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float3 row3(const float* p) {
  return make_float3(p[0], p[1], p[2]);
}

// --- PCG4D (ops/rng_pcg.py) ------------------------------------------------
__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

__device__ __forceinline__ float to_unit(uint32_t u) {
  return static_cast<float>(u >> 8) * (1.0f / 16777216.0f);
}

// uniform_pcg_coords(seed, ctr, n, px, py): block b of ctr draws dims
// 4b .. 4b+3 from pcg4d(px, py, ctr * blocks + b, seed).
__device__ __forceinline__ void draw4(uint32_t px, uint32_t py, uint32_t zz,
                                      uint32_t seed, float* u) {
  uint32_t x = px, y = py, z = zz, w = seed;
  pcg4d(x, y, z, w);
  u[0] = to_unit(x);
  u[1] = to_unit(y);
  u[2] = to_unit(z);
  u[3] = to_unit(w);
}

// --- the R_d sampler (ops/rng_pcg.r2_planes) --------------------------------
constexpr uint32_t kR2Camera = 0x52AD1A7Eu;  // the camera dimensions' channel
constexpr uint32_t kR2Nee = 0x1D0C0FFEu;     // bounce 0's NEE dimensions' channel

// _R2_U32[n][k]: alpha_k of the n-dimensional sequence as a uint32 fraction
__host__ __device__ constexpr uint32_t r2_alpha(int n, int k) {
  return n == 2 ? (k == 0 ? 0xC13FA9A9u : 0x91E10DA6u)
       : n == 3 ? (k == 0 ? 0xD1B54A33u : k == 1 ? 0xABC98389u : 0x8CB92BA7u)
       : (k == 0 ? 0xDB4F0B91u : k == 1 ? 0xBBE05633u : k == 2 ? 0xA0F2EC76u : 0x89E18285u);
}

// r2_planes(seed, gpass, kN, px, py, channel): the rotation pcg4d(px, py,
// channel, seed) plus gpass * alpha, wrapping.
template <int kN>
__device__ __forceinline__ void draw_r2(uint32_t px, uint32_t py, uint32_t channel,
                                        uint32_t seed, uint32_t gpass, float* u) {
  uint32_t x = px, y = py, z = channel, w = seed;
  pcg4d(x, y, z, w);
  const uint32_t rot[4] = {x, y, z, w};
#pragma unroll
  for (int k = 0; k < kN; ++k) u[k] = to_unit(rot[k] + gpass * r2_alpha(kN, k));
}

// --- camera (wavefront._camera_rays, pinhole) -----------------------------
__device__ __forceinline__ float3 camera_dir(const Args& a, float qx, float qy,
                                             float qz, float qw, float ix,
                                             float iy, float u1, float u2) {
  const float ncx = ((ix + u1) * 2.0f / static_cast<float>(a.width) - 1.0f) * a.ratio_x;
  const float ncy = ((iy + u2) * 2.0f / static_cast<float>(a.height) - 1.0f) * a.ratio_y;
  const float vx = ncx, vy = 1.0f, vz = ncy;
  const float tx = qy * vz - qz * vy + qw * vx;
  const float ty = qz * vx - qx * vz + qw * vy;
  const float tz = qx * vy - qy * vx + qw * vz;
  const float dx = vx + 2.0f * (qy * tz - qz * ty);
  const float dy = vy + 2.0f * (qz * tx - qx * tz);
  const float dz = vz + 2.0f * (qx * ty - qy * tx);
  const float n = sqrtf(dx * dx + dy * dy + dz * dz);
  return make_float3(dx / n, dy / n, dz / n);
}

// v rotated by the camera quaternion (wavefront._camera_rays rot)
__device__ __forceinline__ float3 quat_rot(float4 q, float vx, float vy, float vz) {
  const float tx = q.y * vz - q.z * vy + q.w * vx;
  const float ty = q.z * vx - q.x * vz + q.w * vy;
  const float tz = q.x * vy - q.y * vx + q.w * vz;
  return make_float3(vx + 2.0f * (q.y * tz - q.z * ty), vy + 2.0f * (q.z * tx - q.x * tz),
                     vz + 2.0f * (q.x * ty - q.y * tx));
}

// The thin-lens camera ray (wavefront._camera_rays with lens=(u3, u4)): the
// lens point at radius aperture sqrt(u3), angle 2 pi u4 on the sensor plane,
// aimed at the pixel's point on the y = focus_dist plane; sets o (before the
// o + d * 0 of the caller) and d.
__device__ __forceinline__ void thin_lens_ray(const Args& a, float4 q, float3 cam, float ix,
                                              float iy, const float* u, float3& o, float3& d) {
  const float ncx = ((ix + u[0]) * 2.0f / static_cast<float>(a.width) - 1.0f) * a.ratio_x;
  const float ncy = ((iy + u[1]) * 2.0f / static_cast<float>(a.height) - 1.0f) * a.ratio_y;
  const float rr = a.aperture * sqrtf(u[2]);
  const float phi = kTwoPi * u[3];
  const float lx = rr * cosf(phi), lz = rr * sinf(phi);
  const float fd = a.focus_dist;
  const float3 v = quat_rot(q, ncx * fd - lx, 0.0f + fd, ncy * fd - lz);
  const float n = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  d = make_float3(v.x / n, v.y / n, v.z / n);
  const float3 l = quat_rot(q, lx, 0.0f, lz);
  o = make_float3(cam.x + l.x, cam.y + l.y, cam.z + l.z);
}

// --- intersection (wavefront._sphere_hits / _tri_hits_unrolled) -----------
// Nearest root > t_min of the sphere row s: returns t, sets disc.
__device__ __forceinline__ float sphere_t(const float* s, float3 o, float3 d,
                                          float t_min, float& disc) {
  const float ocx = o.x - s[0], ocy = o.y - s[1], ocz = o.z - s[2];
  const float r = s[3];
  const float b = ocx * d.x + ocy * d.y + ocz * d.z;
  const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  disc = b * b - c0;
  const float sq = sqrtf(vmax(disc, 0.0f));
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  return t0 > t_min ? t0 : t1;
}

// Möller-Trumbore against triangle row tr; true when it hits in
// (t_min, best_t), with the distance in t.
__device__ __forceinline__ bool tri_hit(const float* tr, float3 o, float3 d,
                                        float t_min, float best_t, float& t) {
  const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
  const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
  const float px = d.y * e2z - d.z * e2y;
  const float py = d.z * e2x - d.x * e2z;
  const float pz = d.x * e2y - d.y * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < 1e-9f ? 1.0f : det);
  const float tvx = o.x - tr[0], tvy = o.y - tr[1], tvz = o.z - tr[2];
  const float u = (tvx * px + tvy * py + tvz * pz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float vv = (d.x * qx + d.y * qy + d.z * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return fabsf(det) >= 1e-9f && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
         t > t_min && t < best_t;
}

// --- hit UVs (wavefront._poly_atan2 .. _tri_uv_gather) ----------------------
// The JAX package's polynomial inverse trig, in its order of operations
// (no atan2f / acosf: their roundings differ from the plain version's).
__device__ __forceinline__ float poly_atan2(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = vmax(ax, ay);
  const float a = vmin(ax, ay) / vmax(hi, 1e-30f);
  const float s = a * a;
  float r = a * (0x1.ffee7p-1f +
                 s * (-0x1.523a08p-2f +
                      s * (0x1.70edc4p-3f + s * (-0x1.5cb46cp-4f + s * 0x1.555cbep-6f))));
  r = ay > ax ? kHalfPi - r : r;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float poly_acos(float x) {
  const float ax = vmin(vmax(fabsf(x), 0.0f), 1.0f);
  const float r =
      sqrtf(1.0f - ax) *
      (0x1.921b48p+0f + ax * (-0x1.b26908p-3f + ax * (0x1.302c4ep-4f - ax * 0x1.32dc6p-6f)));
  return x < 0.0f ? kPi - r : r;
}

// The spheres' analytic UVs from the unnormalized outward normal p - c.
__device__ __forceinline__ float2 sphere_uv(float3 n) {
  const float ln = vmax(sqrtf(dot3(n, n)), 1e-20f);
  return make_float2(poly_atan2(n.y, n.x) * kHalfInvPi + 0.5f,
                     poly_acos(vmin(vmax(n.z / ln, -1.0f), 1.0f)) * kInvPi);
}

// An unrolled slot's UV at p (triangle row tr, UV row q): the barycentrics
// recomputed from the triangle, then the corners interpolated.
__device__ __forceinline__ float2 tri_uv_at(const float* tr, const float* q, float3 p) {
  const float3 e1 = row3(tr + 3), e2 = row3(tr + 6);
  const float3 ng = cross3(e1, e2);
  const float nn = vmax(dot3(ng, ng), 1e-30f);
  const float3 rel = sub3(p, row3(tr));
  const float inv = 1.0f / nn;
  const float ub = dot3(scale3(cross3(e2, ng), inv), rel);
  const float vb = dot3(scale3(cross3(ng, e1), inv), rel);
  const float u0 = __ldg(q), v0 = __ldg(q + 1);
  const float du1 = __ldg(q + 2) - u0, du2 = __ldg(q + 4) - u0;
  return make_float2(u0 + ub * du1 + vb * du2,
                     v0 + ub * (__ldg(q + 3) - v0) + vb * (__ldg(q + 5) - v0));
}

// The unrolled slot's texture-u tangent (with tri_uv_at's UV): du1 grad(u)
// + du2 grad(v), the barycentric gradients of the triangle.
__device__ __forceinline__ float3 tri_tan_at(const float* tr, const float* q) {
  const float3 e1 = row3(tr + 3), e2 = row3(tr + 6);
  const float3 ng = cross3(e1, e2);
  const float nn = vmax(dot3(ng, ng), 1e-30f);
  const float inv = 1.0f / nn;
  const float3 gu = scale3(cross3(e2, ng), inv);
  const float3 gv = scale3(cross3(ng, e1), inv);
  const float u0 = __ldg(q);
  const float du1 = __ldg(q + 2) - u0, du2 = __ldg(q + 4) - u0;
  return add3(scale3(gu, du1), scale3(gv, du2));
}

struct Hit {
  float t;
  float3 p, n;  // n: unit, facing the ray
  int mat;
  float light_area;
  bool front;
  float2 uv;  // texture UV (kMat scenes whose shading reads UVs)
  float3 tan;   // kTex: the raw world texture-u tangent (0 without one)
  bool is_tri;  // kTex: a triangle hit (the footprint's UV density)
};

// wavefront._intersect (unrolled slots), wavefront._intersect_clusters (a
// mesh, the attributes path) or wavefront._intersect_instanced (instances);
// returns false on a miss (t = BIG) and for an inactive lane. kMat: the hit's
// UV too, where the scene's shading reads it (0 on instances, and on a
// ClusterSet or slots without UVs). kTex: the UV on instances of a UV set
// too, and the texture-u tangent (wavefront._surface's `tan`).
template <int kMesh, bool kWarp, bool kMat = false, bool kTex = false>
__device__ __forceinline__ bool intersect(const Scene& sc, float3 o, float3 d,
                                          float t_min, Hit& h, bool active = true) {
  static_assert(kWarp || kMesh == kMeshNone, "a mesh is swept by the warp's lanes together");
  float t_s = kBig;
  int i_s = -1;
  for (int k = 0; k < sc.n_sph; ++k) {
    float disc;
    const float t = sphere_t(sc.sph + k * kSphW, o, d, t_min, disc);
    if (disc > 0.0f && t > t_min && t < t_s) {
      t_s = t;
      i_s = k;
    }
  }
  float t_t = kBig;
  int i_t = -1;
  cl::SweepHit ch;
  ins::InstHit ih;
  const bool instanced = has_instances<kMesh>(sc), mesh = has_clusters<kMesh>(sc);
  if (instanced) {
    if constexpr (kTex) {
      ins::instanced_sweep_warp<ins::kAttrTan>(sc.cl, sc.inst, o, d, kBig, t_min, false, true,
                                               active, ih, sc.cl_uv);
    } else {
      ins::instanced_sweep_warp(sc.cl, sc.inst, o, d, kBig, t_min, false, true, active, ih);
    }
    if (ih.code >= 0) t_t = ih.t;
  } else if (mesh) {
    cl::sweep_warp(sc.cl, o, d, kBig, t_min, false, active, ch);
    if (ch.idx >= 0) t_t = ch.t;
  } else {
    for (int k = 0; k < sc.n_tri; ++k) {
      float t;
      if (tri_hit(sc.tri + k * kTriW, o, d, t_min, t_t, t)) {
        t_t = t;
        i_t = k;
      }
    }
  }
  const bool use_tri = t_t < t_s;
  const float t = fminf(t_s, t_t);
  if (!active || !(t < kBig)) return false;
  h.t = t;
  h.p = make_float3(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t);
  float3 n;
  float light_area;
  if constexpr (kMat) h.uv = make_float2(0.0f, 0.0f);
  if constexpr (kTex) {
    h.tan = make_float3(0.0f, 0.0f, 0.0f);
    h.is_tri = use_tri;
  }
  if (use_tri && instanced) {
    n = ih.n;
    light_area = 1.0f;
    h.mat = static_cast<int>(ins::hit_material(sc.inst, ih.code));
    if constexpr (kTex) {
      if (sc.needs_uv) h.uv = ih.uv;
      h.tan = ih.tan;
    }
  } else if (use_tri && mesh) {
    float mat, area2;
    cl::hit_attrs(sc.cl, ch, n, mat, area2);
    light_area = area2 * 0.5f;
    h.mat = static_cast<int>(mat);
    if constexpr (kMat) {
      if (sc.needs_uv && sc.cl_uv != nullptr) h.uv = cl::hit_uv(sc.cl_uv, ch);
    }
    if constexpr (kTex) {
      if (sc.cl_uv != nullptr) h.tan = cl::hit_tan(sc.cl, sc.cl_uv, ch);
    }
  } else if (use_tri) {
    const float* tr = sc.tri + i_t * kTriW;
    n = cross3(row3(tr + 3), row3(tr + 6));
    light_area = 0.5f * sqrtf(dot3(n, n));
    h.mat = static_cast<int>(tr[9]);
    if constexpr (kMat) {
      if (sc.needs_uv && sc.tri_uv) h.uv = tri_uv_at(tr, sc.tri_uvs + i_t * 8, h.p);
    }
    if constexpr (kTex) {
      if (sc.tri_uv) h.tan = tri_tan_at(tr, sc.tri_uvs + i_t * 8);
    }
  } else {
    const float* s = sc.sph + i_s * kSphW;
    n = sub3(h.p, row3(s));
    light_area = kFourPi * s[3] * s[3];
    h.mat = static_cast<int>(s[4]);
    if constexpr (kMat) {
      if (sc.needs_uv) h.uv = sphere_uv(n);
    }
    if constexpr (kTex) h.tan = make_float3(-n.y, n.x, 0.0f);  // wavefront._sphere_tan
  }
  const float nlen = vmax(sqrtf(dot3(n, n)), 1e-20f);
  n = scale3(n, 1.0f / nlen);
  const bool flip = dot3(n, d) > 0.0f;
  h.n = flip ? make_float3(-n.x, -n.y, -n.z) : n;
  h.front = !flip;
  h.light_area = light_area;
  return true;
}

// wavefront._occluded: any live sphere or triangle (or mesh, or instance) hit in
// (t_min, max_t). An inactive lane (kWarp) enters the mesh sweep without a
// ray; what it returns is not to be read.
template <int kMesh, bool kWarp>
__device__ __forceinline__ bool occluded(const Scene& sc, float3 o, float3 d,
                                         float max_t, float t_min, bool active = true) {
  bool sphere = false;  // kWarp: blocked by a sphere, the mesh sweep entered inactive
  for (int k = 0; k < sc.n_sph; ++k) {
    float disc;
    const float t = sphere_t(sc.sph + k * kSphW, o, d, t_min, disc);
    if (disc > 0.0f && t > t_min && t < max_t) {
      if (!kWarp) return true;
      sphere = true;
      break;
    }
  }
  if (has_instances<kMesh>(sc)) {
    ins::InstHit h;
    ins::instanced_sweep_warp(sc.cl, sc.inst, o, d, max_t, t_min, true, false, active && !sphere,
                              h);
    return sphere || h.code >= 0;
  }
  if (has_clusters<kMesh>(sc)) {
    cl::SweepHit h;
    cl::sweep_warp(sc.cl, o, d, max_t, t_min, true, active && !sphere, h);
    return sphere || h.idx >= 0;
  }
  if (sphere) return true;
  for (int k = 0; k < sc.n_tri; ++k) {
    float t;
    if (tri_hit(sc.tri + k * kTriW, o, d, t_min, max_t, t)) return true;
  }
  return false;
}

// --- NEE light sample (wavefront._sample_light, power or uniform) ---------
struct LightSample {
  float3 p, n, le;
  float pdf_area;
};

// The light tree's weight of cluster c at p (wavefront._tree_cluster_weights):
// power / max(dist², radius², 1e-12).
__device__ __forceinline__ float tree_weight(const Lights& L, int c, float3 p) {
  const float* r = L.lt + c * kTreeW;
  const float dx = p.x - __ldg(r), dy = p.y - __ldg(r + 1), dz = p.z - __ldg(r + 2);
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float rad = __ldg(r + 3);
  return __ldg(r + 4) / vmax(vmax(d2, rad * rad), 1e-12f);
}

// The light tree's slot for u_sel at p (wavefront._sample_light, tree_p): a
// cluster by the running CDF of the weights (summed in cluster order), u_sel
// rescaled into its interval, then the first slot of that cluster whose
// within-cluster CDF exceeds it; pick: the cluster's probability times the
// slot's within it.
__device__ __forceinline__ int tree_walk(const Scene& sc, const Lights& L, float3 p, float u_sel,
                                         float& pick) {
  float wtot = tree_weight(L, 0, p);
  for (int c = 1; c < L.n_clusters; ++c) wtot = wtot + tree_weight(L, c, p);
  const float uw = u_sel * wtot;
  float cum = tree_weight(L, 0, p);
  float cl = 0.0f, lo = 0.0f, w_sel = cum;
  for (int c = 1; c < L.n_clusters; ++c) {
    const float w = tree_weight(L, c, p);
    if (uw >= cum) {
      cl = cl + 1.0f;
      lo = cum;
      w_sel = w;
    }
    cum = cum + w;
  }
  const float p_cl = w_sel / vmax(wtot, 1e-30f);
  const float u_in = vmin(vmax((uw - lo) / vmax(w_sel, 1e-30f), 0.0f), kBelowOne);
  int idx = sc.L - 1;
  for (int k = 0; k < sc.L; ++k) {
    const float* row = sc.light + k * kLightW;
    if (row[9] == cl && u_in < row[10]) {
      idx = k;
      break;
    }
  }
  pick = p_cl * sc.light[idx * kLightW + 11];
  return idx;
}

// Texel (ty, tx) of component block `block` of a lane-row table of K rows a
// block (wavefront._fetch_row_block): a row outside 0..K-1 reads 0.
__device__ __forceinline__ float block_fetch(const float* tab, int K, int block, int ty, int tx) {
  return ty >= 0 && ty < K ? __ldg(tab + (block * K + ty) * kTexW + min(max(tx, 0), kTexW - 1))
                           : 0.0f;
}

// The mesh pseudo-slot's point at a triangle slot's barycentrics (kLights):
// on the lane's own triangle, alias-sampled from the lane tables by u_tri
// (wavefront._sample_mesh_tri_lane), or on the pass's (mesh_row: the
// scalars of the plain version's row, its point summed left to right and
// its normal from the scalar cross product).
__device__ __forceinline__ void mesh_light_point(const Lights& L, const LightArgs& la, float u1,
                                                 float u2, LightSample& ls) {
  const float su = sqrtf(u1);
  const float b1 = su * (1.0f - u2);
  const float b2 = su * u2;
  if (L.lane_mesh) {
    const int K = L.mlt_k;
    const float N = static_cast<float>(K * kTexW);
    const float x = la.u_tri * N;
    const float j = vmin(vmax(floorf(x), 0.0f), N - 1.0f);
    const float f = x - j;
    const float ty0 = floorf(j / 128.0f);
    const int tx0 = static_cast<int>(j - ty0 * 128.0f);
    const int y0 = static_cast<int>(ty0);
    const float ap = block_fetch(L.mlt_smp, K, 0, y0, tx0);
    const float t = f < ap ? j : block_fetch(L.mlt_smp, K, 1, y0, tx0);
    const float ty = floorf(t / 128.0f);
    const int tx = static_cast<int>(t - ty * 128.0f);
    const int y = static_cast<int>(ty);
    float c[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) c[k] = block_fetch(L.mlt_rows, K, k, y, tx);
    const float3 v0 = make_float3(c[0], c[1], c[2]);
    const float3 e1 = make_float3(c[3], c[4], c[5]);
    const float3 e2 = make_float3(c[6], c[7], c[8]);
    ls.p = add3(v0, add3(scale3(e1, b1), scale3(e2, b2)));
    const float3 nt = cross3(e1, e2);
    ls.n = scale3(nt, 1.0f / vmax(sqrtf(dot3(nt, nt)), 1e-20f));
    ls.le = make_float3(c[9], c[10], c[11]);
    return;
  }
  const float* m = la.mesh_row;
  ls.p = make_float3(__ldg(m) + __ldg(m + 3) * b1 + __ldg(m + 6) * b2,
                     __ldg(m + 1) + __ldg(m + 4) * b1 + __ldg(m + 7) * b2,
                     __ldg(m + 2) + __ldg(m + 5) * b1 + __ldg(m + 8) * b2);
  const float ncx = __ldg(m + 4) * __ldg(m + 8) - __ldg(m + 5) * __ldg(m + 7);
  const float ncy = __ldg(m + 5) * __ldg(m + 6) - __ldg(m + 3) * __ldg(m + 8);
  const float ncz = __ldg(m + 3) * __ldg(m + 7) - __ldg(m + 4) * __ldg(m + 6);
  const float ninv = 1.0f / vmax(sqrtf(ncx * ncx + ncy * ncy + ncz * ncz), 1e-20f);
  ls.n = make_float3(ncx * ninv + 0.0f * b1, ncy * ninv + 0.0f * b1, ncz * ninv + 0.0f * b1);
  ls.le = make_float3(__ldg(m + 9), __ldg(m + 10), __ldg(m + 11));
}

// A light point and its area pdf for NEE, the slot by power or uniformly;
// kLights adds wavefront._sample_light's tree_p, mesh_light and u_tri (L and
// la): the slot by the light tree at *la->tree_p where it is given, and the
// mesh pseudo-slot's point on the pass's triangle or the lane's own.
template <bool kLights = false>
__device__ __forceinline__ LightSample sample_light(const Scene& sc, float u_sel,
                                                    float u1, float u2,
                                                    bool uniform, const Lights* L = nullptr,
                                                    const LightArgs* la = nullptr) {
  const int count = max(sc.n_light, 1);
  int idx = 0;
  float tree_pick = 0.0f;
  if (kLights && la->tree_p != nullptr) {
    idx = tree_walk(sc, *L, *la->tree_p, u_sel, tree_pick);
  } else if (uniform) {
    idx = min(static_cast<int>(u_sel * static_cast<float>(count)), count - 1);
  } else {
    for (int k = 0; k < sc.L - 1; ++k) idx += u_sel >= sc.light[k * kLightW + 7] ? 1 : 0;
  }
  LightSample ls;
  const float* row = sc.light + idx * kLightW;
  const int kind = static_cast<int>(row[0]);
  const int prim = static_cast<int>(row[1]);
  const float area = row[2];
  ls.le = row3(row + 3);
  if (kind == kLightTri) {
    const bool ok = prim >= 0 && prim < min(sc.T, kTriUnrollMax);
    const float* tr = sc.tri + prim * kTriW;
    const float3 v0 = ok ? row3(tr) : make_float3(0.0f, 0.0f, 0.0f);
    const float3 e1 = ok ? row3(tr + 3) : make_float3(0.0f, 0.0f, 0.0f);
    const float3 e2 = ok ? row3(tr + 6) : make_float3(0.0f, 0.0f, 0.0f);
    const float su = sqrtf(u1);
    const float b1 = su * (1.0f - u2);
    const float b2 = su * u2;
    ls.p = add3(v0, add3(scale3(e1, b1), scale3(e2, b2)));
    const float3 nt = cross3(e1, e2);
    ls.n = scale3(nt, 1.0f / vmax(sqrtf(dot3(nt, nt)), 1e-20f));
  } else if (kLights && kind == kLightMesh && (L->lane_mesh || la->mesh_row != nullptr)) {
    mesh_light_point(*L, *la, u1, u2, ls);
  } else {
    const bool ok = prim >= 0 && prim < sc.S;
    const float* s = sc.sph + prim * kSphW;
    const float3 c = ok ? row3(s) : make_float3(0.0f, 0.0f, 0.0f);
    const float r = ok ? s[3] : 0.0f;
    const float z = 1.0f - 2.0f * u1;
    const float rr = sqrtf(vmax(1.0f - z * z, 0.0f));
    const float phi = kTwoPi * u2;
    ls.n = make_float3(rr * cosf(phi), rr * sinf(phi), z);
    ls.p = add3(c, scale3(ls.n, r));
  }
  ls.pdf_area = kLights && la->tree_p != nullptr ? tree_pick / vmax(area, 1e-20f)
                : uniform ? 1.0f / (area * static_cast<float>(count))
                          : row[6] / vmax(area, 1e-20f);
  return ls;
}

// sampler.power_heuristic
__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  return a2 / vmax(a2 + b * b, 1e-24f);
}

// sampler.build_onb (Duff et al. 2017): t, s around unit n.
__device__ __forceinline__ void build_onb(float3 n, float3& t, float3& s) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  t = make_float3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
  s = make_float3(b, sign + n.y * n.y * a, -n.y);
}

// sampler.cosine_hemisphere about unit n; pdf = z / π.
__device__ __forceinline__ float3 cosine_hemisphere(float u1, float u2, float3 n,
                                                    float& pdf) {
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(vmax(1.0f - u1, 0.0f));
  float3 t, s;
  build_onb(n, t, s);
  pdf = z / kPi;
  return add3(add3(scale3(t, x), scale3(s, y)), scale3(n, z));
}

// --- GGX microfacet (sampler.py: ggx_d .. ggx_eval), the plain version's
// operation order; Schlick's x^5 as XLA's x * ((x * x) * (x * x)) --------
__device__ __forceinline__ float clamp01(float x) { return vmin(vmax(x, 0.0f), 1.0f); }

__device__ __forceinline__ float schlick5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float ggx_d(float cos_h, float alpha) {
  const float a2 = alpha * alpha;
  const float c2 = cos_h * cos_h;
  const float denom = c2 * (a2 - 1.0f) + 1.0f;
  return a2 / vmax(kPi * denom * denom, 1e-12f);
}

__device__ __forceinline__ float ggx_smith_g1(float cos_v, float alpha) {
  const float a2 = alpha * alpha;
  const float c = vmax(cos_v, 1e-6f);
  return 2.0f * c / vmax(c + sqrtf(a2 + (1.0f - a2) * c * c), 1e-12f);
}

__device__ __forceinline__ float3 sample_ggx_h(float u1, float u2, float3 n, float alpha,
                                              float& cos_h) {
  const float a2 = alpha * alpha;
  cos_h = sqrtf(clamp01((1.0f - u1) / (1.0f + (a2 - 1.0f) * u1)));
  const float sin_h = sqrtf(vmax(1.0f - cos_h * cos_h, 0.0f));
  const float phi = kTwoPi * u2;
  float3 t, s;
  build_onb(n, t, s);
  return add3(add3(scale3(t, sin_h * cosf(phi)), scale3(s, sin_h * sinf(phi))),
              scale3(n, cos_h));
}

__device__ __forceinline__ float ggx_d_aniso(float hx, float hy, float hz, float ax, float ay) {
  const float qx = hx / ax;
  const float qy = hy / ay;
  const float e = qx * qx + qy * qy + hz * hz;
  return 1.0f / vmax(kPi * ax * ay * e * e, 1e-12f);
}

__device__ __forceinline__ float ggx_smith_g1_aniso(float vx, float vy, float vz, float ax,
                                                    float ay) {
  const float vz2 = vmax(vz * vz, 1e-12f);
  const float lam = 0.5f * (sqrtf(1.0f + (ax * ax * vx * vx + ay * ay * vy * vy) / vz2) - 1.0f);
  return vz > 1e-6f ? 1.0f / (1.0f + lam) : 0.0f;
}

__device__ __forceinline__ float3 sample_ggx_h_aniso(float u1, float u2, float3 t, float3 s,
                                                     float3 n, float ax, float ay) {
  const float r = sqrtf(vmin(vmax(u1 / vmax(1.0f - u1, 1e-12f), 0.0f), 1e12f));
  const float phi = kTwoPi * u2;
  const float sx = ax * r * cosf(phi);
  const float sy = ay * r * sinf(phi);
  const float inv = 1.0f / sqrtf(1.0f + sx * sx + sy * sy);
  return add3(add3(scale3(t, sx * inv), scale3(s, sy * inv)), scale3(n, inv));
}

// The normalized half-vector of wo and wi (sampler.ggx_eval's first lines).
__device__ __forceinline__ float3 half_vector(float3 wo, float3 wi) {
  const float3 h_raw = add3(wo, wi);
  const float hl = vmax(sqrtf(dot3(h_raw, h_raw)), 1e-12f);
  return scale3(h_raw, 1.0f / hl);
}

// Schlick Fresnel times spec: f = (f0 + (1 - f0) p5) * spec, per channel.
__device__ __forceinline__ float3 fresnel_spec(float3 f0, float oh, float spec) {
  const float p5 = schlick5(1.0f - clamp01(oh));
  return make_float3((f0.x + (1.0f - f0.x) * p5) * spec, (f0.y + (1.0f - f0.y) * p5) * spec,
                     (f0.z + (1.0f - f0.z) * p5) * spec);
}

// sampler.ggx_eval: the GGX conductor BRDF f and the pdf of its sampling.
__device__ __forceinline__ float3 ggx_eval(float3 n, float3 wo, float3 wi, float3 f0,
                                           float alpha, float& pdf) {
  const float3 h = half_vector(wo, wi);
  const float cos_h = dot3(n, h);
  const float cos_o = dot3(n, wo);
  const float cos_i = dot3(n, wi);
  const float oh = dot3(wo, h);
  const float d = ggx_d(cos_h, alpha);
  const float g = ggx_smith_g1(cos_o, alpha) * ggx_smith_g1(cos_i, alpha);
  const float denom = vmax(4.0f * cos_o * cos_i, 1e-6f);
  const bool valid = cos_i > 0.0f && cos_o > 0.0f && oh > 0.0f;
  pdf = valid ? d * vmax(cos_h, 0.0f) / vmax(4.0f * oh, 1e-6f) : 0.0f;
  return fresnel_spec(f0, oh, valid ? d * g / denom : 0.0f);
}

// sampler.ggx_eval_aniso, in the frame (t, s, n).
__device__ __forceinline__ float3 ggx_eval_aniso(float3 n, float3 t, float3 s, float3 wo,
                                                 float3 wi, float3 f0, float ax, float ay,
                                                 float& pdf) {
  const float3 h = half_vector(wo, wi);
  const float hx = dot3(h, t), hy = dot3(h, s), hz = dot3(h, n);
  const float ox = dot3(wo, t), oy = dot3(wo, s), oz = dot3(wo, n);
  const float ix = dot3(wi, t), iy = dot3(wi, s), iz = dot3(wi, n);
  const float oh = dot3(wo, h);
  const float d = ggx_d_aniso(hx, hy, hz, ax, ay);
  const float g = ggx_smith_g1_aniso(ox, oy, oz, ax, ay) * ggx_smith_g1_aniso(ix, iy, iz, ax, ay);
  const float denom = vmax(4.0f * oz * iz, 1e-6f);
  const bool valid = iz > 0.0f && oz > 0.0f && oh > 0.0f;
  pdf = valid ? d * vmax(hz, 0.0f) / vmax(4.0f * oh, 1e-6f) : 0.0f;
  return fresnel_spec(f0, oh, valid ? d * g / denom : 0.0f);
}

// A hit's GGX parameters (kMat, metal scenes): alpha = max(r², 1e-4) of the
// roughness, alpha_y of roughness_y with anisotropy, and the per-normal frame
// the anisotropy axes live in.
struct Ggx {
  float alpha, alpha_y;
  float3 t, s;
};

// sampler.ggx_eval or ggx_eval_aniso, by the scene's flag.
__device__ __forceinline__ float3 ggx_brdf(const Scene& sc, const Ggx& g, float3 n, float3 wo,
                                           float3 wi, float3 f0, float& pdf) {
  if (sc.aniso) return ggx_eval_aniso(n, g.t, g.s, wo, wi, f0, g.alpha, g.alpha_y, pdf);
  return ggx_eval(n, wo, wi, f0, g.alpha, pdf);
}

// --- the atlas and the env map (wavefront._atlas_fetch .. _sample_rect) -----
// Texel (ty, tx) of channel c of a (3K, 128) channel-major table; a row
// outside 0..K-1 reads 0. ty, tx: whole numbers >= 0 on every lane that
// reaches here (tx is clamped to the row as the plain version clamps it).
__device__ __forceinline__ float tab_fetch(const float* tab, int K, float ty, float tx, int c) {
  const int y = static_cast<int>(ty);
  const int x = min(max(static_cast<int>(tx), 0), kTexW - 1);
  return y >= 0 && y < K ? __ldg(tab + (c * K + y) * kTexW + x) : 0.0f;
}

__device__ __forceinline__ float3 tab_fetch3(const float* tab, int K, float ty, float tx) {
  return make_float3(tab_fetch(tab, K, ty, tx, 0), tab_fetch(tab, K, ty, tx, 1),
                     tab_fetch(tab, K, ty, tx, 2));
}

// The four rect-clamped corners of the rect [x0, y0, tw, th] lerped at the
// texel centres, at the wrapped (fu, fv): sample_rect's bilinear filter.
__device__ __forceinline__ float3 rect_bilinear(const Scene& sc, float x0, float y0, float tw,
                                                float th, float fu, float fv) {
  const float fx = fu * tw - 0.5f;
  const float fy = fv * th - 0.5f;
  const float xf = floorf(fx);
  const float yf = floorf(fy);
  const float wx = fx - xf;
  const float wy = fy - yf;
  const float xa = vmax(x0 + vmin(vmax(xf, 0.0f), tw - 1.0f), 0.0f);
  const float xb = vmax(x0 + vmin(vmax(xf + 1.0f, 0.0f), tw - 1.0f), 0.0f);
  const float ya = vmax(y0 + vmin(vmax(yf, 0.0f), th - 1.0f), 0.0f);
  const float yb = vmax(y0 + vmin(vmax(yf + 1.0f, 0.0f), th - 1.0f), 0.0f);
  const float3 c00 = tab_fetch3(sc.atlas, sc.atlas_k, ya, xa);
  const float3 c10 = tab_fetch3(sc.atlas, sc.atlas_k, ya, xb);
  const float3 c01 = tab_fetch3(sc.atlas, sc.atlas_k, yb, xa);
  const float3 c11 = tab_fetch3(sc.atlas, sc.atlas_k, yb, xb);
  const float ux = 1.0f - wx, uy = 1.0f - wy;
  return make_float3((c00.x * ux + c10.x * wx) * uy + (c01.x * ux + c11.x * wx) * wy,
                     (c00.y * ux + c10.y * wx) * uy + (c01.y * ux + c11.y * wx) * wy,
                     (c00.z * ux + c10.z * wx) * uy + (c01.z * ux + c11.z * wx) * wy);
}

// The atlas rect [x0, y0, tw, th] at the scale-tiled UV: one texel, or the
// four rect-clamped corners lerped at the texel centres (bilinear).
__device__ __forceinline__ float3 sample_rect(const Scene& sc, const float* rect, float2 uv,
                                              float s) {
  const float x0 = rect[0], y0 = rect[1], tw = rect[2], th = rect[3];
  float fu = uv.x * s;
  float fv = uv.y * s;
  fu = fu - floorf(fu);  // wrap (tile) addressing
  fv = fv - floorf(fv);
  if (!sc.bilinear) {
    const float tx = vmax(x0 + vmin(vmax(floorf(fu * tw), 0.0f), tw - 1.0f), 0.0f);
    const float ty = vmax(y0 + vmin(vmax(floorf(fv * th), 0.0f), th - 1.0f), 0.0f);
    return tab_fetch3(sc.atlas, sc.atlas_k, ty, tx);
  }
  return rect_bilinear(sc, x0, y0, tw, th, fu, fv);
}

// --- the texture features (kTex) --------------------------------------------
// The ray cone's footprint at a hit in UV units (wavefront._mip_lod_footprint):
// width tacc * lod_alpha / sqrt(|d.n|) (n the geometric normal), times the UV
// density: |tan| on a triangle, on a sphere the larger of 1 / (2π |tan|) and
// 1 / (π r), r from the light area 4π r².
__device__ __forceinline__ float mip_footprint(const Scene& sc, const Hit& h, float3 d,
                                               float tacc) {
  const float tl = sqrtf(dot3(h.tan, h.tan));
  const float sph_r = sqrtf(h.light_area * kQuarterInvPi);
  const float sph_dens =
      vmax(1.0f / (kTwoPi * vmax(tl, 1e-8f)), 1.0f / (kPi * vmax(sph_r, 1e-8f)));
  const float inv_du = h.is_tri ? tl : sph_dens;
  const float cosw = fabsf(dot3(d, h.n));
  const float width = tacc * sc.lod_alpha / sqrtf(vmax(cosw, 1e-2f));
  return width * inv_du;
}

// The trilinear sample of a material's albedo mip chain (the L rects at
// mrow + c_mips; wavefront._sample_rect_tri): lod = log2 of the footprint in
// level-0 texels, clamped to the chain; the two bracketing levels sampled
// bilinearly and lerped by lod's fraction. A level outside the chain (a NaN
// lod) reads the empty rect.
__device__ __forceinline__ float3 sample_rect_tri(const Scene& sc, const float* mrow, float2 uv,
                                                  float s, float fp) {
  const float* mips = mrow + sc.c_mips;
  const int L = sc.n_mips;
  const float texels = fp * s * vmax(mips[2], 1.0f);
  const float lod = log2f(vmin(vmax(texels, 1.0f), static_cast<float>(1 << (L - 1))));
  const float l0 = floorf(lod);
  const float fr = lod - l0;
  float fu = uv.x * s;
  float fv = uv.y * s;
  fu = fu - floorf(fu);
  fv = fv - floorf(fv);
  float3 c[2];
  const float lev[2] = {l0, vmin(l0 + 1.0f, static_cast<float>(L - 1))};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* r = lev[k] >= 0.0f && lev[k] < static_cast<float>(L)
                         ? mips + 4 * static_cast<int>(lev[k])
                         : zero;
    c[k] = rect_bilinear(sc, r[0], r[1], r[2], r[3], fu, fv);
  }
  const float gr = 1.0f - fr;
  return make_float3(c[0].x * gr + c[1].x * fr, c[0].y * gr + c[1].y * fr,
                     c[0].z * gr + c[1].z * fr);
}

// Tangent-space normal mapping (wavefront._perturb_normal): the map's texel
// (the rect and UV tiling at mrow + c_nrm, bilinear unless the filter is
// nearest) decoded as 2 rgb - 1 and turned into world space by (T, n x T,
// n), T the raw tangent made orthogonal to the unit normal n (degenerate:
// z x n, or x x n near ±z) and normalized. A decoded texel of length <=
// 1e-6 keeps n, as does a material without a map (w = 0).
__device__ __forceinline__ float3 perturb_normal(const Scene& sc, const float* mrow, float3 n,
                                                 float3 tan, float2 uv) {
  const float* r = mrow + sc.c_nrm;
  if (!(r[2] > 0.0f)) return n;
  const float3 rgb = sample_rect(sc, r, uv, r[4]);
  const float ntx = 2.0f * rgb.x - 1.0f;
  const float nty = 2.0f * rgb.y - 1.0f;
  const float ntz = 2.0f * rgb.z - 1.0f;
  float3 tp = sub3(tan, scale3(n, dot3(n, tan)));
  const float3 fb = fabsf(n.z) < 0.9f ? cross3(make_float3(0.0f, 0.0f, 1.0f), n)
                                      : cross3(make_float3(1.0f, 0.0f, 0.0f), n);
  if (!(dot3(tp, tp) > 1e-12f)) tp = fb;
  const float3 t = scale3(tp, 1.0f / vmax(sqrtf(dot3(tp, tp)), 1e-20f));
  const float3 b = cross3(n, t);
  const float3 np = make_float3(ntx * t.x + nty * b.x + ntz * n.x,
                                ntx * t.y + nty * b.y + ntz * n.y,
                                ntx * t.z + nty * b.z + ntz * n.z);
  const float ln = sqrtf(dot3(np, np));
  return ln > 1e-6f ? scale3(np, 1.0f / vmax(ln, 1e-20f)) : n;
}

// The env map's texel (ty, tx) of direction d (wavefront._env_texel_of).
__device__ __forceinline__ void env_texel_of(const Scene& sc, float3 d, float& ty, float& tx) {
  const float u = poly_atan2(d.y, d.x) * kHalfInvPi + 0.5f;
  const float v = poly_acos(vmin(vmax(d.z, -1.0f), 1.0f)) * kInvPi;
  tx = vmin(vmax(floorf(u * 128.0f), 0.0f), 127.0f);
  ty = vmin(vmax(floorf(v * static_cast<float>(sc.env_k)), 0.0f),
            static_cast<float>(sc.env_k - 1));
}

// The env NEE sampler's solid-angle pdf in texel (ty, tx): p_sel N / (2π² sinθ).
__device__ __forceinline__ float env_pdf_w(const Scene& sc, float ty, float tx, float sin_t) {
  const float psel = tab_fetch(sc.env_smp, sc.env_k, ty, tx, 0);
  return psel * static_cast<float>(sc.env_k * kTexW) / vmax(kTwoPiPi * sin_t, 1e-8f);
}

// Alias-sample an env texel with the selection uniform s and jitter inside
// it by (j1, j2) (wavefront._sample_env): the direction, its pdf and Le.
__device__ __forceinline__ float3 sample_env(const Scene& sc, float s, float j1, float j2,
                                             float& pdf, float3& le) {
  const int K = sc.env_k;
  const float N = static_cast<float>(K * kTexW);
  const float x = s * N;
  const float j = vmin(vmax(floorf(x), 0.0f), N - 1.0f);
  const float f = x - j;
  const float ty0 = floorf(j / 128.0f);
  const float tx0 = j - ty0 * 128.0f;
  const float ap = tab_fetch(sc.env_smp, K, ty0, tx0, 1);  // the alias table's accept prob
  const float t = f < ap ? j : tab_fetch(sc.env_smp, K, ty0, tx0, 2);
  const float ty = floorf(t / 128.0f);
  const float tx = t - ty * 128.0f;
  const float u = (tx + j1) / 128.0f;
  const float v = (ty + j2) / static_cast<float>(K);
  const float theta = v * kPi;
  const float phi = (u - 0.5f) * kTwoPi;
  const float sin_t = sinf(theta);
  le = tab_fetch3(sc.env_img, K, ty, tx);
  pdf = tab_fetch(sc.env_smp, K, ty, tx, 0) * N / vmax(kTwoPiPi * sin_t, 1e-8f);
  return make_float3(sin_t * cosf(phi), sin_t * sinf(phi), cosf(theta));
}

// --- one ray's state and one bounce (wavefront._bounce) -------------------
// The 17 planes of wavefront.pack_state, in registers, then chan, that of a
// dispersive scene (the committed color channel, -1: none yet), and tacc,
// the ray cone's path length under the trilinear filter (kTex).
struct Ray {
  float3 o, d, thr, rad;
  bool alive, prev_did_nee;
  float prev_pdf;
  uint32_t px, py;  // global pixel coordinates: every draw is keyed on them
  float chan;
  float tacc;
};

// The camera ray of pixel (px, py) for the pass of `seed` (ctr 0), global
// pass gpass: the pinhole, or, in the sampling instantiations (kSamp), the
// thin lens (aperture > 0: two more dimensions) and the dimensions from the
// R_d sequence under r2.
template <bool kSamp = false>
__device__ __forceinline__ Ray camera_ray(const Args& a, uint32_t px, uint32_t py,
                                          uint32_t seed, uint32_t gpass, float3 cam, float4 q) {
  float u[4];
  const bool lens = kSamp && a.aperture > 0.0f;
  if (kSamp && a.r2) {
    if (lens) {
      draw_r2<4>(px, py, kR2Camera, static_cast<uint32_t>(a.seed), gpass, u);
    } else {
      draw_r2<2>(px, py, kR2Camera, static_cast<uint32_t>(a.seed), gpass, u);
    }
  } else {
    draw4(px, py, 0u, seed, u);
  }
  Ray r;
  if (lens) {
    thin_lens_ray(a, q, cam, static_cast<float>(px), static_cast<float>(py), u, r.o, r.d);
  } else {
    r.d = camera_dir(a, q.x, q.y, q.z, q.w, static_cast<float>(px), static_cast<float>(py),
                     u[0], u[1]);
    r.o = make_float3(cam.x + r.d.x * 0.0f, cam.y + r.d.y * 0.0f, cam.z + r.d.z * 0.0f);
  }
  r.o = add3(r.o, scale3(r.d, 0.0f));
  r.thr = make_float3(1.0f, 1.0f, 1.0f);
  r.rad = make_float3(0.0f, 0.0f, 0.0f);
  r.alive = true;
  r.prev_did_nee = false;
  r.prev_pdf = 0.0f;
  r.px = px;
  r.py = py;
  r.chan = -1.0f;
  r.tacc = 0.0f;
  return r;
}

// A ray that missed or died: parked as the plain version parks it (origin
// 1e18, direction (1, 1, 1)/sqrt(3), throughput 0), so every later sweep
// and the regroup keys treat it as dead. Its radiance and chan stay.
__device__ __forceinline__ void park(Ray& r) {
  r.o = make_float3(kDeadO, kDeadO, kDeadO);
  r.d = make_float3(kInvSqrt3, kInvSqrt3, kInvSqrt3);
  r.thr = make_float3(0.0f, 0.0f, 0.0f);
  r.alive = false;
  r.prev_did_nee = false;
  r.prev_pdf = 0.0f;
}

// The gradient sky an escaped ray reads at full weight, added to r.rad
// (wavefront._bounce, scene.has_env: thr * (sky * 1)).
__device__ __forceinline__ void add_sky(const Scene& sc, Ray& r, float3 thr, float3 d) {
  const float tz = 0.5f * (d.z + 1.0f);
  const float* e = sc.env;
  r.rad.x = r.rad.x + thr.x * (e[0] + (e[4] - e[0]) * tz);
  r.rad.y = r.rad.y + thr.y * (e[1] + (e[5] - e[1]) * tz);
  r.rad.z = r.rad.z + thr.z * (e[2] + (e[6] - e[2]) * tz);
}

// An escaped ray's env-map texel, MIS-weighted against the env NEE of the
// previous vertex (its pick times the env pdf of this direction), added to
// r.rad (wavefront._bounce, scene.has_env_map).
__device__ __forceinline__ void add_env_map(const Args& a, const Scene& sc, Ray& r, float3 thr,
                                            float3 d) {
  float ty, tx;
  env_texel_of(sc, d, ty, tx);
  const float3 e_rad = tab_fetch3(sc.env_img, sc.env_k, ty, tx);
  const float sin_t = sqrtf(vmax(1.0f - d.z * d.z, 1e-12f));
  const float w = r.prev_did_nee && a.use_nee
                      ? power_heuristic(r.prev_pdf, sc.env_pick * env_pdf_w(sc, ty, tx, sin_t))
                      : 1.0f;
  r.rad.x = r.rad.x + thr.x * (e_rad.x * w);
  r.rad.y = r.rad.y + thr.y * (e_rad.y * w);
  r.rad.z = r.rad.z + thr.z * (e_rad.z * w);
}

// The NEE shadow ray of a diffuse hit at p (normal n) toward a light sample
// (wavefront._bounce's NEE): false when the sample casts none.
struct Nee {
  LightSample ls;
  float3 wi;
  float dist, cos_ll, cos_s;
  float pdf_w, max_t;  // with an env map: the pdf with its branch's pick, the shadow ray's reach
};
template <bool kLights = false>
__device__ __forceinline__ bool nee_sample(const Args& a, const Scene& sc, float3 p, float3 n,
                                           const float* u, bool uniform, Nee& e,
                                           const Lights* L = nullptr,
                                           const LightArgs* la = nullptr) {
  e.ls = sample_light<kLights>(sc, u[2], u[3], u[4], uniform, L, la);
  const float3 to_l = sub3(e.ls.p, p);
  e.dist = sqrtf(dot3(to_l, to_l));
  e.wi = scale3(to_l, 1.0f / vmax(e.dist, 1e-20f));
  e.cos_ll = fabsf(dot3(e.ls.n, e.wi));
  e.cos_s = dot3(n, e.wi);
  return e.cos_ll > 1e-6f && e.dist > a.eps && e.cos_s > 0.0f;
}

// With an env map, NEE flips one coin between the map and the light table,
// and rescales the selection uniform into the branch it took (wavefront.py
// _bounce, JAX :1838-1846): the map's alias-sampled texel (unbounded shadow
// ray) or a light sample; each pdf carries its branch's pick.
template <bool kLights = false>
__device__ __forceinline__ bool nee_sample_env(const Args& a, const Scene& sc, float3 p,
                                               float3 n, const float* u, bool uniform, Nee& e,
                                               const Lights* L = nullptr,
                                               const LightArgs* la = nullptr) {
  const float pick = sc.env_pick;
  bool ok;
  if (u[2] < pick) {
    float pdf;
    e.wi = sample_env(sc, vmin(vmax(u[2] / vmax(pick, 1e-6f), 0.0f), kBelowOne), u[3], u[4],
                      pdf, e.ls.le);
    e.pdf_w = pick * pdf;
    e.dist = 1e4f;
    e.max_t = kBig;
    ok = true;
  } else {
    const float u_sel = vmin(vmax((u[2] - pick) / vmax(1.0f - pick, 1e-6f), 0.0f), kBelowOne);
    e.ls = sample_light<kLights>(sc, u_sel, u[3], u[4], uniform, L, la);
    const float3 to_l = sub3(e.ls.p, p);
    e.dist = sqrtf(dot3(to_l, to_l));
    e.wi = scale3(to_l, 1.0f / vmax(e.dist, 1e-20f));
    e.cos_ll = fabsf(dot3(e.ls.n, e.wi));
    e.pdf_w = (1.0f - pick) * (e.ls.pdf_area * (e.dist * e.dist) / vmax(e.cos_ll, 1e-6f));
    e.max_t = e.dist * 0.999f;
    ok = e.cos_ll > 1e-6f && e.dist > a.eps && sc.n_light > 0;
  }
  e.cos_s = dot3(n, e.wi);
  return ok && e.cos_s > 0.0f;
}

// NEE with the env map where the material instantiation has one, else
// toward the light table alone, as the other instantiations always do:
// whether a vertex has an NEE target, the shadow ray, its reach and the
// sample's solid-angle pdf. kLights: the light sample with the light
// features (lt; mesh_row: the pass's mesh-light row, or null): the tree at
// p + eps n (the next segment's origin, where the hit-side density
// evaluates it), the pass's mesh-light row or the lane's triangle (its draw
// dimension, the first after the fixed ones).
template <bool kMat>
__device__ __forceinline__ bool nee_target(const Scene& sc) {
  if constexpr (kMat) return sc.n_light > 0 || sc.env_map;
  return sc.n_light > 0;
}
template <bool kMat, bool kLights = false>
__device__ __forceinline__ bool nee_cast(const Args& a, const Scene& sc, float3 p, float3 n,
                                         const float* u, bool uniform, Nee& e,
                                         const Lights* lt = nullptr,
                                         const float* mesh_row = nullptr) {
  LightArgs la;  // (kLights)
  float3 tree_p;
  if constexpr (kLights) {
    tree_p = add3(p, scale3(n, a.eps));
    la = LightArgs{mesh_row, lt->tree ? &tree_p : nullptr,
                   lt->lane_mesh ? u[a.rr_start > 0 ? 6 : 5] : 0.0f};
  }
  if constexpr (kMat) {
    if (sc.env_map) return nee_sample_env<kLights>(a, sc, p, n, u, uniform, e, lt, &la);
  }
  return nee_sample<kLights>(a, sc, p, n, u, uniform, e, lt, &la);
}
template <bool kMat>
__device__ __forceinline__ float nee_reach(const Scene& sc, const Nee& e) {
  if constexpr (kMat) {
    if (sc.env_map) return e.max_t;
  }
  return e.dist * 0.999f;
}
template <bool kMat>
__device__ __forceinline__ float nee_pdf_w(const Scene& sc, const Nee& e) {
  if constexpr (kMat) {
    if (sc.env_map) return e.pdf_w;
  }
  return e.ls.pdf_area * (e.dist * e.dist) / vmax(e.cos_ll, 1e-6f);
}

// The light an unoccluded shadow ray brings, MIS-weighted, added to r.rad;
// kLights: times the shadow segment's fog transmittance (wavefront._bounce's
// scale * exp(-fog_density dist); fog_density 0: none).
template <bool kLights = false>
__device__ __forceinline__ void nee_add(Ray& r, float3 thr, float3 albedo, const Nee& e,
                                        float pdf_w, float fog_density = 0.0f) {
  const float w_nee = power_heuristic(pdf_w, e.cos_s / kPi);
  float s = e.cos_s / vmax(pdf_w, 1e-20f) * w_nee / kPi;
  if constexpr (kLights) {
    if (fog_density > 0.0f) s = s * expf(-fog_density * e.dist);
  }
  r.rad.x = r.rad.x + thr.x * albedo.x * (e.ls.le.x * s);
  r.rad.y = r.rad.y + thr.y * albedo.y * (e.ls.le.y * s);
  r.rad.z = r.rad.z + thr.z * albedo.z * (e.ls.le.z * s);
}

// nee_add's general form, taken in scenes with metal (JAX
// wavefront.py:1904-1915): f = albedo/π on a diffuse hit, the GGX BRDF on a
// metal one, and the MIS counter-pdf of the same BSDF; kLights as nee_add.
template <bool kLights = false>
__device__ __forceinline__ void nee_add_brdf(const Scene& sc, Ray& r, float3 thr, float3 albedo,
                                             bool is_metal, const Ggx& g, float3 n, float3 d,
                                             const Nee& e, float pdf_w,
                                             float fog_density = 0.0f) {
  float pdf_b;
  float3 f;
  if (is_metal) {
    f = ggx_brdf(sc, g, n, make_float3(-d.x, -d.y, -d.z), e.wi, albedo, pdf_b);
  } else {
    pdf_b = e.cos_s / kPi;
    f = scale3(albedo, kInvPi);
  }
  const float w_nee = power_heuristic(pdf_w, pdf_b);
  float s = e.cos_s / vmax(pdf_w, 1e-20f) * w_nee;
  if constexpr (kLights) {
    if (fog_density > 0.0f) s = s * expf(-fog_density * e.dist);
  }
  r.rad.x = r.rad.x + thr.x * f.x * (e.ls.le.x * s);
  r.rad.y = r.rad.y + thr.y * f.y * (e.ls.le.y * s);
  r.rad.z = r.rad.z + thr.z * f.z * (e.ls.le.z * s);
}

// Fog over the segment just intersected (wavefront._bounce, JAX
// wavefront.py:1617-1683; kLights): Beer–Lambert over it (an escape 1e4 long)
// and the fog color's in-scatter, then with single scattering the
// equiangular scatter vertex: a light point first (power or uniform
// selection, never the tree), the scatter
// distance by the angle the point subtends, an isotropic phase, both legs
// attenuated, and the vertex's own shadow ray, which every lane of the warp
// form enters (a lane without one inactive). Then attenuates r.thr.
template <int kMesh, bool kWarp>
__device__ __forceinline__ void fog_segment(const Args& a, const Scene& sc, const Lights& L,
                                            Ray& r, bool hit, float t, const float* u,
                                            const float* mesh_row, bool uniform, unsigned& nrays,
                                            bool live) {
  const float seg = hit ? t : 1e4f;
  const float trans = expf(-L.fog_density * seg);
  const float inscat = 1.0f - trans;
  const float3 thr = r.thr;
  if (live) {
    r.rad.x = r.rad.x + thr.x * inscat * L.fog_color.x;
    r.rad.y = r.rad.y + thr.y * inscat * L.fog_color.y;
    r.rad.z = r.rad.z + thr.z * inscat * L.fog_color.z;
  }
  if (L.media) {
    bool cand = false;
    float3 xm = r.o, wim = make_float3(1.0f, 0.0f, 0.0f), le = make_float3(0.0f, 0.0f, 0.0f);
    float rdist = 0.0f, gain = 0.0f;
    if (live) {
      // the media's dimensions after the fixed ones and the lane mesh light's
      const float* um = u + (a.rr_start > 0 ? 6 : 5) + (L.lane_mesh ? 1 : 0);
      const LightArgs la{mesh_row, nullptr, L.lane_mesh ? um[4] : 0.0f};
      const LightSample lm = sample_light<true>(sc, um[0], um[1], um[2], uniform, &L, &la);
      const float3 o = r.o, d = r.d;
      const float3 rel = sub3(lm.p, o);
      const float delta = dot3(rel, d);
      const float3 perp = sub3(rel, scale3(d, delta));
      const float d_m = sqrtf(vmax(dot3(perp, perp), 1e-12f));
      const float tha = poly_atan2(-delta, d_m);
      const float thb = poly_atan2(seg - delta, d_m);
      const float th = tha + (thb - tha) * um[3];
      float tt = delta + d_m * (sinf(th) / vmax(cosf(th), 1e-9f));
      tt = vmin(vmax(tt, 0.0f), seg);
      const float dt = tt - delta;
      const float pdf_t = d_m / vmax((thb - tha) * (d_m * d_m + dt * dt), 1e-12f);
      xm = add3(o, scale3(d, tt));
      const float3 tol = sub3(lm.p, xm);
      rdist = sqrtf(dot3(tol, tol));
      wim = scale3(tol, 1.0f / vmax(rdist, 1e-20f));
      const float cos_lm = fabsf(dot3(lm.n, wim));
      cand = sc.n_light > 0 && rdist > a.eps && thb > tha + 1e-7f;
      gain = L.fog_scatter * expf(-L.fog_density * tt) * kQuarterInvPi * cos_lm *
             expf(-L.fog_density * rdist) / vmax(lm.pdf_area * rdist * rdist * pdf_t, 1e-20f);
      le = lm.le;
    }
    if (cand) nrays += 1;
    bool blocked;
    if constexpr (kWarp) {
      blocked = occluded<kMesh, true>(sc, xm, wim, rdist * 0.999f, a.t_min, cand);
    } else {
      blocked = cand && occluded<kMesh, false>(sc, xm, wim, rdist * 0.999f, a.t_min);
    }
    if (cand && !blocked) {
      r.rad.x = r.rad.x + thr.x * (le.x * gain);
      r.rad.y = r.rad.y + thr.y * (le.y * gain);
      r.rad.z = r.rad.z + thr.z * (le.z * gain);
    }
  }
  if (live) r.thr = scale3(thr, trans);
}

// Whether a ray hit a triangle and the hit's slot (wavefront._surface's
// is_tri and `prim`), from the sphere and unrolled-triangle tests of
// intersect run again: a triangle where the hit's distance t_hit is under
// the nearest sphere's (intersect's t_t < t_s); prim the sphere's, or the
// unrolled triangle's, -1 on a mesh.
template <int kMesh>
__device__ __forceinline__ bool hit_slot(const Scene& sc, float3 o, float3 d, float t_min,
                                         float t_hit, int& prim) {
  float t_s = kBig;
  int i_s = -1;
  for (int k = 0; k < sc.n_sph; ++k) {
    float disc;
    const float t = sphere_t(sc.sph + k * kSphW, o, d, t_min, disc);
    if (disc > 0.0f && t > t_min && t < t_s) {
      t_s = t;
      i_s = k;
    }
  }
  if (!(t_hit < t_s)) {
    prim = i_s;
    return false;
  }
  if (has_instances<kMesh>(sc) || has_clusters<kMesh>(sc)) {
    prim = -1;
    return true;
  }
  float t_t = kBig;
  int i_t = -1;
  for (int k = 0; k < sc.n_tri; ++k) {
    float t;
    if (tri_hit(sc.tri + k * kTriW, o, d, t_min, t_t, t)) {
      t_t = t;
      i_t = k;
    }
  }
  prim = i_t;
  return true;
}

// The light tree's MIS density of the light a ray hit, seen from the
// previous vertex at the ray's origin o (wavefront._bounce, JAX
// wavefront.py:1741-1767): the hit's slot by its (prim, kind) match, the
// slot's cluster weighted at o; a light NEE cannot address matches no slot
// and has density 0.
__device__ __forceinline__ float tree_density(const Scene& sc, const Lights& L, bool is_tri,
                                              int prim, const Hit& h, float3 o) {
  float clh = 0.0f, pick_h = 0.0f;
  for (int k = 0; k < sc.L; ++k) {
    const float* row = sc.light + k * kLightW;
    if (prim == static_cast<int>(row[1]) && is_tri == (static_cast<int>(row[0]) == kLightTri)) {
      clh = clh + row[9];
      pick_h = pick_h + row[11];
    }
  }
  float wtot = 0.0f, w_sel = 0.0f;
  for (int c = 0; c < L.n_clusters; ++c) {
    const float w = tree_weight(L, c, o);
    wtot = c == 0 ? w : wtot + w;
    if (clh == static_cast<float>(c)) w_sel = w_sel + w;
  }
  const float p_cl = w_sel / vmax(wtot, 1e-30f);
  return p_cl * pick_h / vmax(h.light_area, 1e-20f);
}

// The hit-side MIS density of the light a ray (o, d) hit with the light
// features (wavefront._bounce, JAX wavefront.py:1727-1790), given the
// density without them: the light tree's, or for a triangle with mesh
// lights the pseudo-slot's over the total emissive area (uniform
// selection: 1 / (area count); power: pick / area; the pass's row, or the
// lane tables' [area, pick]).
template <int kMesh>
__device__ __forceinline__ float light_density(const Args& a, const Scene& sc, const Lights& L,
                                               const Hit& h, float3 o, float3 d, bool uniform,
                                               const float* mesh_row, float density) {
  const bool mesh_lights = mesh_row != nullptr || L.lane_mesh;
  if (!(mesh_lights || (L.tree && !uniform))) return density;
  int prim;
  const bool is_tri = hit_slot<kMesh>(sc, o, d, a.t_min, h.t, prim);
  if (L.tree && !uniform) return tree_density(sc, L, is_tri, prim, h, o);
  if (!is_tri) return density;
  const float area = L.lane_mesh ? L.mesh_area : __ldg(mesh_row + 12);
  if (uniform) return 1.0f / vmax(area * static_cast<float>(max(sc.n_light, 1)), 1e-20f);
  return (L.lane_mesh ? L.mesh_pick : __ldg(mesh_row + 13)) / vmax(area, 1e-20f);
}

// Bounce b of a live ray for the pass of `seed`: adds its emission, sky and
// NEE to r.rad, scatters or parks it, and counts its rays (one segment, one
// shadow-ray candidate) into nrays. With kWarp every lane of the warp calls
// it together, a lane without a live ray with live false (it parks the ray,
// keeps its radiance and counts no ray). kMat adds the material features'
// branches, each under its scene flag, and kTex (with kMat) the texture
// features'; kSamp the R_d sampler's bounce-0 NEE dimensions (global pass
// gpass); kLights (with kSamp) the light features, each under its flag in
// *lt (mesh_row: the pass's mesh-light row, or null): the draw of JAX's nu
// (the lane mesh light's dimension, then the media's 4 or 5, after the
// fixed ones), the fog over each segment (fog_segment), the hit-side MIS
// density of the tree and of mesh lights (light_density), and NEE with
// nee_cast's light features and the shadow segment's fog.
template <int kMesh, bool kWarp, bool kMat, bool kTex = false, bool kSamp = false,
          bool kLights = false>
__device__ __forceinline__ void bounce(const Args& a, const Scene& sc, Ray& r, int b,
                                       uint32_t seed, uint32_t gpass, unsigned& nrays,
                                       bool live = true, const Lights* lt = nullptr,
                                       const float* mesh_row = nullptr) {
  static_assert(kMat || !kTex, "the texture instantiation is a material one");
  static_assert(kSamp || !kLights, "the light forms take the sampling features too");
  const bool uniform = a.uniform_lights != 0;
  float u[kLights ? 12 : 8];
  if constexpr (kLights) {
    // two blocks of 4 (6 or 7 dims with the lane mesh light's), three with
    // the media's (nu 9 to 12)
    const uint32_t blocks = lt->media ? 3u : 2u;
    for (uint32_t k = 0; k < blocks; ++k) {
      draw4(r.px, r.py, static_cast<uint32_t>(b + 1) * blocks + k, seed, u + 4 * k);
    }
  } else {
    // bounce draws: ctr b + 1, two blocks of 4 (nu = 5, or 6 with RR)
    draw4(r.px, r.py, static_cast<uint32_t>(b + 1) * 2u, seed, u);
    draw4(r.px, r.py, static_cast<uint32_t>(b + 1) * 2u + 1u, seed, u + 4);
  }
  // R_d: bounce 0's NEE light dimensions u[2..4] from the 3-D sequence
  if (kSamp && a.r2 && a.use_nee && b == 0) {
    draw_r2<3>(r.px, r.py, kR2Nee, static_cast<uint32_t>(a.seed), gpass, u + 2);
  }
  if (live) nrays += 1;
  const float3 d = r.d;

  Hit h;
  if (kWarp) {  // a miss goes on to the shadow sweep as a hit on nothing
    h.t = 0.0f;
    h.p = r.o;
    h.n = make_float3(0.0f, 0.0f, 1.0f);
    h.mat = -1;
    h.light_area = 0.0f;
    h.front = true;
  }
  const bool hit = intersect<kMesh, kWarp, kMat, kTex>(sc, r.o, d, a.t_min, h, live);
  if constexpr (kLights) {
    if (lt->fog) fog_segment<kMesh, kWarp>(a, sc, *lt, r, hit, h.t, u, mesh_row, uniform, nrays,
                                           live);
  }
  if (!kWarp && !hit) {
    if (kMat && sc.sky) add_sky(sc, r, r.thr, d);
    if (kMat && sc.env_map) add_env_map(a, sc, r, r.thr, d);
    park(r);
    return;
  }
  const float3 p = h.p;
  const float3 thr = r.thr;
  const bool mat_ok = h.mat >= 0 && h.mat < sc.M;
  const float* mrow = sc.mat + h.mat * (kMat ? sc.mat_w : kMatW);
  // every later step reads the shading normal: kTex's normal map perturbs it
  float3 n = h.n;
  if constexpr (kTex) {
    if (sc.normal_map && hit && mat_ok) n = perturb_normal(sc, mrow, n, h.tan, h.uv);
    // the ray cone grows by this segment before the hit is shaded
    if (sc.tacc && hit) r.tacc = r.tacc + h.t;
  }
  float3 albedo = mat_ok ? row3(mrow) : make_float3(0.0f, 0.0f, 0.0f);
  const float3 emission = mat_ok ? row3(mrow + 3) : make_float3(0.0f, 0.0f, 0.0f);
  const int kind = mat_ok ? static_cast<int>(mrow[6]) : 0;
  const float ior = mat_ok ? mrow[7] : 0.0f;
  const bool is_metal = kMat && sc.metal && kind == kMetal;
  Ggx g;
  if (is_metal) {
    const float rough = mrow[sc.c_rough];
    g.alpha = vmax(rough * rough, 1e-4f);
    if (sc.aniso) {
      const float rough2 = mrow[sc.c_rough2];
      g.alpha_y = vmax(rough2 * rough2, 1e-4f);
      build_onb(n, g.t, g.s);
    }
  }
  if (kMat && sc.texture && mat_ok) {
    // the checker, in world space or (tex_space 1) in UV space: the parity of
    // the summed cells is a floored modulo, cells - 2 floor(cells / 2) (exact:
    // cells are whole numbers); then an image texture (rect w > 0) at the UV
    const float s = mrow[sc.c_tex + 3];
    float cells = floorf(p.x * s) + floorf(p.y * s) + floorf(p.z * s);
    if (sc.uv_space && mrow[sc.c_space] > 0.5f) cells = floorf(h.uv.x * s) + floorf(h.uv.y * s);
    if (s > 0.0f && cells - 2.0f * floorf(cells * 0.5f) >= 1.0f) albedo = row3(mrow + sc.c_tex);
    if (sc.image && mrow[sc.c_rect + 2] > 0.0f) {
      bool trilinear = false;
      if constexpr (kTex) {
        if (sc.tacc) {
          trilinear = true;
          albedo = sample_rect_tri(sc, mrow, h.uv, s, mip_footprint(sc, h, d, r.tacc));
        }
      }
      if (!trilinear) albedo = sample_rect(sc, mrow + sc.c_rect, h.uv, s);
    }
  }

  // --- emission (MIS vs NEE of the previous vertex) -----------------------
  if (emission.x > 0.0f || emission.y > 0.0f || emission.z > 0.0f) {
    const float cos_l = fabsf(dot3(n, d));
    float sel_density;
    if (uniform) {
      sel_density = 1.0f / vmax(h.light_area * static_cast<float>(max(sc.n_light, 1)), 1e-20f);
    } else {
      const float lum_e = 0.2126f * emission.x + 0.7152f * emission.y + 0.0722f * emission.z;
      sel_density = lum_e / vmax(sc.total_power, 1e-20f);
    }
    if constexpr (kLights) {  // the light tree's, a mesh-light triangle's
      sel_density = light_density<kMesh>(a, sc, *lt, h, r.o, d, uniform, mesh_row, sel_density);
    }
    // the light table's NEE branch runs with probability 1 - env_pick
    if (kMat && sc.env_map && a.use_nee) sel_density = sel_density * (1.0f - sc.env_pick);
    const float pdf_light_w = sel_density * (h.t * h.t) / vmax(cos_l, 1e-6f);
    const float gate = r.prev_did_nee ? power_heuristic(r.prev_pdf, pdf_light_w) : 1.0f;
    r.rad.x = r.rad.x + thr.x * (emission.x * gate);
    r.rad.y = r.rad.y + thr.y * (emission.y * gate);
    r.rad.z = r.rad.z + thr.z * (emission.z * gate);
  }
  // the warp form's miss reads the sky (or the env map) here, once, before it
  // parks below
  if (kWarp && kMat && sc.sky && live && !hit) add_sky(sc, r, thr, d);
  if (kWarp && kMat && sc.env_map && live && !hit) add_env_map(a, sc, r, thr, d);

  // --- NEE ------------------------------------------------------------------
  // (with an env map a vertex does NEE without slot lights too)
  const bool nee_kind = kind == kDiffuse || is_metal;
  float fog = 0.0f;  // the shadow segment's
  if constexpr (kLights) fog = lt->fog ? lt->fog_density : 0.0f;
  const bool nee = hit && a.use_nee && nee_kind && nee_target<kMat>(sc);
  if (kWarp) {  // every lane reaches the shadow sweep; those without one inactive
    Nee e;
    e.wi = make_float3(1.0f, 0.0f, 0.0f);
    e.dist = 0.0f;
    if constexpr (kMat) e.max_t = 0.0f;
    const bool cast = nee && nee_cast<kMat, kLights>(a, sc, p, n, u, uniform, e, lt, mesh_row);
    if (cast) nrays += 1;
    const float3 sh_o = add3(p, scale3(n, a.eps));
    const bool blocked =
        occluded<kMesh, kWarp>(sc, sh_o, e.wi, nee_reach<kMat>(sc, e), a.t_min, cast);
    if (cast && !blocked) {
      const float pdf_w = nee_pdf_w<kMat>(sc, e);
      if (kMat && sc.metal) {
        nee_add_brdf<kLights>(sc, r, thr, albedo, is_metal, g, n, d, e, pdf_w, fog);
      } else {
        nee_add<kLights>(r, thr, albedo, e, pdf_w, fog);
      }
    }
    if (!hit) {
      park(r);
      return;
    }
  } else if (nee) {
    Nee e;
    if (nee_cast<kMat, kLights>(a, sc, p, n, u, uniform, e, lt, mesh_row)) {
      nrays += 1;
      const float3 sh_o = add3(p, scale3(n, a.eps));
      if (!occluded<kMesh, kWarp>(sc, sh_o, e.wi, nee_reach<kMat>(sc, e), a.t_min)) {
        const float pdf_w = nee_pdf_w<kMat>(sc, e);
        if (kMat && sc.metal) {
          nee_add_brdf<kLights>(sc, r, thr, albedo, is_metal, g, n, d, e, pdf_w, fog);
        } else {
          nee_add<kLights>(r, thr, albedo, e, pdf_w, fog);
        }
      }
    }
  }

  // --- scatter --------------------------------------------------------------
  float3 new_d, new_o;
  float3 w_mat = albedo;  // the throughput weight: albedo, or f cos / pdf on metal
  float3 thr_s = thr;     // thr after a dispersive glass hit's channel pick
  float w_rough = 1.0f;   // the Walter weight of a rough-glass hit (kMat)
  float pdf_bsdf = 0.0f;
  if (kind == kMirror) {
    new_d = sub3(d, scale3(n, 2.0f * dot3(d, n)));
    new_o = add3(p, scale3(n, a.eps));
  } else if (kind == kDielectric) {
    float ior_c = ior;
    if (kMat && sc.dispersion) {
      // the first dispersive glass hit commits the lane to one channel (3x
      // one-hot throughput) and shifts its ior; u[1] is free on glass lanes
      const float dispm = mrow[sc.c_disp];
      if (dispm > 0.0f && r.chan < 0.0f) {
        r.chan = vmin(vmax(floorf(u[1] * 3.0f), 0.0f), 2.0f);
        thr_s = make_float3(thr.x * (3.0f * (r.chan == 0.0f ? 1.0f : 0.0f)),
                            thr.y * (3.0f * (r.chan == 1.0f ? 1.0f : 0.0f)),
                            thr.z * (3.0f * (r.chan == 2.0f ? 1.0f : 0.0f)));
      }
      const float shift = r.chan >= 0.0f ? (r.chan - 1.0f) * 0.5f : 0.0f;
      ior_c = ior + dispm * shift;
    }
    // exact unpolarized Fresnel split; u[0] is the R/T coin
    const float eta = h.front ? 1.0f / ior_c : ior_c;
    const float cosi = -dot3(d, n);
    const float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const float cost = sqrtf(vmax(kk, 0.0f));
    const float rs = (eta * cosi - cost) / vmax(eta * cosi + cost, 1e-20f);
    const float rp = (eta * cost - cosi) / vmax(eta * cost + cosi, 1e-20f);
    const float refl_p = kk <= 0.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
    bool rough = false;
    if constexpr (kMat) {
      if (sc.rough_diel && mrow[sc.c_rough] > 0.0f) {
        // GGX rough glass (Walter 2007): a half-vector from u[3], u[4] (free
        // on glass lanes), the same Fresnel coin about it, and the weight
        // |d·h| G / (cos_o cos_h); a sample on its branch's wrong side (or h
        // facing away) weighs 0 and the path dies below
        rough = true;
        const float rough_d = mrow[sc.c_rough];
        const float alpha = vmax(rough_d * rough_d, 1e-4f);
        float cos_hd;
        const float3 hd = sample_ggx_h(u[3], u[4], n, alpha, cos_hd);
        const float cosi_h = -dot3(d, hd);
        const float kk_h = 1.0f - eta * eta * (1.0f - cosi_h * cosi_h);
        const float cost_h = sqrtf(vmax(kk_h, 0.0f));
        const float rs_h = (eta * cosi_h - cost_h) / vmax(eta * cosi_h + cost_h, 1e-20f);
        const float rp_h = (eta * cost_h - cosi_h) / vmax(eta * cost_h + cosi_h, 1e-20f);
        const float reflp_h = kk_h <= 0.0f ? 1.0f : 0.5f * (rs_h * rs_h + rp_h * rp_h);
        const bool refl_h = u[0] < reflp_h;
        new_d = refl_h ? sub3(d, scale3(hd, 2.0f * dot3(d, hd)))
                       : add3(scale3(d, eta), scale3(hd, eta * cosi_h - cost_h));
        new_o = add3(p, scale3(n, refl_h ? a.eps : -a.eps));
        const float cos_i_r = dot3(new_d, n);
        const float g_r = ggx_smith_g1(cosi, alpha) * ggx_smith_g1(fabsf(cos_i_r), alpha);
        const bool ok_r = cosi_h > 0.0f && (refl_h ? cos_i_r > 0.0f : cos_i_r < 0.0f);
        w_rough = ok_r ? fabsf(cosi_h) * g_r / vmax(cosi * vmax(cos_hd, 1e-6f), 1e-6f) : 0.0f;
      }
    }
    if (!rough) {
      if (u[0] < refl_p) {
        new_d = sub3(d, scale3(n, 2.0f * dot3(d, n)));
        new_o = add3(p, scale3(n, a.eps));
      } else {  // refracted rays continue THROUGH the surface
        new_d = add3(scale3(d, eta), scale3(n, eta * cosi - cost));
        new_o = add3(p, scale3(n, -a.eps));
      }
    }
  } else if (is_metal) {
    // GGX conductor: an NDF half-vector from u[0], u[1], reflect, weight
    // f cos / pdf (an under-surface sample: f = pdf = 0, it dies below)
    float cos_h;
    const float3 hv = sc.aniso ? sample_ggx_h_aniso(u[0], u[1], g.t, g.s, n, g.alpha, g.alpha_y)
                               : sample_ggx_h(u[0], u[1], n, g.alpha, cos_h);
    new_d = sub3(d, scale3(hv, 2.0f * dot3(d, hv)));
    new_o = add3(p, scale3(n, a.eps));
    const float3 f = ggx_brdf(sc, g, n, make_float3(-d.x, -d.y, -d.z), new_d, albedo, pdf_bsdf);
    w_mat = scale3(f, pdf_bsdf > 0.0f ? dot3(n, new_d) / vmax(pdf_bsdf, 1e-12f) : 0.0f);
  } else {
    new_d = cosine_hemisphere(u[0], u[1], n, pdf_bsdf);
    new_o = add3(p, scale3(n, a.eps));
  }
  float3 new_thr = make_float3(thr_s.x * w_mat.x, thr_s.y * w_mat.y, thr_s.z * w_mat.z);
  if (kMat && sc.rough_diel && kind == kDielectric) new_thr = scale3(new_thr, w_rough);
  const float thr_max = vmax(new_thr.x, vmax(new_thr.y, new_thr.z));
  if (!(thr_max > 0.0f)) {
    park(r);
    return;
  }
  if (a.rr_start > 0 && b >= a.rr_start) {
    // Russian roulette: survive w.p. p_c, divide throughput by p_c
    const float p_c = vmin(vmax(thr_max, 0.05f), 1.0f);
    if (!(u[5] < p_c)) {
      park(r);
      return;
    }
    new_thr = scale3(new_thr, 1.0f / p_c);
  }
  r.thr = new_thr;
  r.o = new_o;
  r.d = new_d;
  r.prev_did_nee = nee_kind && nee_target<kMat>(sc) && a.use_nee;
  r.prev_pdf = pdf_bsdf;
}

}  // namespace pt
