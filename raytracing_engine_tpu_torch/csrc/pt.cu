// Kernel K4, the sphere path tracer, for Hopper (sm_90a), and its C entry
// point (bound with ctypes by ops/cuda/pt.py and ops/cuda/common.py).
//
// Replaces raytracing_engine_tpu/ops/pallas/pt_kernel.py:_pt_kernel (K4) for
// scenes of spheres and up to TRI_UNROLL_MAX unrolled triangles: the whole
// path of a pixel (camera ray, spp loop, bounce loop, NEE + MIS, the PCG4D
// stream keyed on global pixel coordinates) runs in one thread, in
// registers.
//
// What bounds it on this card: FP32 ALU work and divergence, not bytes. Each
// segment tests every live sphere and triangle (a quadratic or Möller-
// Trumbore, with square roots and divisions), and a pixel's paths end at
// different bounces; the only device-memory traffic is the output,
// 800 x 608 x 12 B = 5.8 MB at BASELINE config 2, and a few KB of scene
// tables. So the design: one thread per pixel running its own spp and
// bounce loops, a thread that misses or dies leaves the loop, warps retire
// on their own; the scene tables load once per block into shared memory and
// every thread of a warp reads the same row (a broadcast); live counts are
// read at run time, so one build serves every scene. None of the TPU
// layout is kept: no tiles, stripes, f32 alive masks or SMEM/VMEM packing.
//
// Rays are counted exactly: one per live path per bounce, one per NEE
// shadow-ray candidate; a warp-level sum, one shared-memory add per warp and
// one 64-bit integer atomicAdd per block.
//
// Block: 16 x 8 threads (a warp covers 16 x 2 pixels); the ragged edge is
// masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see pt.cuh on why no FMA
//        contraction and no fast math)
#include "pt.cuh"

namespace pt {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

// One pass of one pixel (wavefront._trace_core): adds the path's radiance to
// rad and its rays to nrays.
__device__ __forceinline__ void trace_pass(const Args& a, const Scene& sc,
                                           uint32_t px, uint32_t py,
                                           uint32_t seed, float3 cam,
                                           float4 q, float3& rad,
                                           unsigned& nrays) {
  float u[8];
  draw4(px, py, 0u, seed, u);  // camera: ctr 0, one block
  float3 d = camera_dir(a, q.x, q.y, q.z, q.w, static_cast<float>(px),
                        static_cast<float>(py), u[0], u[1]);
  float3 o = make_float3(cam.x + d.x * 0.0f, cam.y + d.y * 0.0f, cam.z + d.z * 0.0f);
  o = add3(o, scale3(d, 0.0f));
  float3 thr = make_float3(1.0f, 1.0f, 1.0f);
  float3 prad = make_float3(0.0f, 0.0f, 0.0f);
  bool prev_did_nee = false;
  float prev_pdf = 0.0f;
  const bool uniform = a.uniform_lights != 0;

  for (int b = 0; b <= a.max_bounces; ++b) {
    // bounce draws: ctr b + 1, two blocks of 4 (nu = 5, or 6 with RR)
    draw4(px, py, static_cast<uint32_t>(b + 1) * 2u, seed, u);
    draw4(px, py, static_cast<uint32_t>(b + 1) * 2u + 1u, seed, u + 4);
    nrays += 1;

    Hit h;
    if (!intersect(sc, o, d, a.t_min, h)) break;
    const float3 n = h.n, p = h.p;
    const bool mat_ok = h.mat >= 0 && h.mat < sc.M;
    const float* mrow = sc.mat + h.mat * kMatW;
    const float3 albedo = mat_ok ? row3(mrow) : make_float3(0.0f, 0.0f, 0.0f);
    const float3 emission = mat_ok ? row3(mrow + 3) : make_float3(0.0f, 0.0f, 0.0f);
    const int kind = mat_ok ? static_cast<int>(mrow[6]) : 0;
    const float ior = mat_ok ? mrow[7] : 0.0f;

    // --- emission (MIS vs NEE of the previous vertex) ---------------------
    if (emission.x > 0.0f || emission.y > 0.0f || emission.z > 0.0f) {
      const float cos_l = fabsf(dot3(n, d));
      float sel_density;
      if (uniform) {
        sel_density = 1.0f / vmax(h.light_area * static_cast<float>(max(sc.n_light, 1)), 1e-20f);
      } else {
        const float lum_e = 0.2126f * emission.x + 0.7152f * emission.y + 0.0722f * emission.z;
        sel_density = lum_e / vmax(sc.total_power, 1e-20f);
      }
      const float pdf_light_w = sel_density * (h.t * h.t) / vmax(cos_l, 1e-6f);
      const float gate = prev_did_nee ? power_heuristic(prev_pdf, pdf_light_w) : 1.0f;
      prad.x = prad.x + thr.x * (emission.x * gate);
      prad.y = prad.y + thr.y * (emission.y * gate);
      prad.z = prad.z + thr.z * (emission.z * gate);
    }

    // --- NEE ----------------------------------------------------------------
    if (a.use_nee && kind == kDiffuse && sc.n_light > 0) {
      const LightSample ls = sample_light(sc, u[2], u[3], u[4], uniform);
      const float3 to_l = sub3(ls.p, p);
      const float dist = sqrtf(dot3(to_l, to_l));
      const float3 wi = scale3(to_l, 1.0f / vmax(dist, 1e-20f));
      const float cos_ll = fabsf(dot3(ls.n, wi));
      const float cos_s = dot3(n, wi);
      if (cos_ll > 1e-6f && dist > a.eps && cos_s > 0.0f) {
        nrays += 1;
        const float3 sh_o = add3(p, scale3(n, a.eps));
        if (!occluded(sc, sh_o, wi, dist * 0.999f, a.t_min)) {
          const float pdf_w = ls.pdf_area * (dist * dist) / vmax(cos_ll, 1e-6f);
          const float w_nee = power_heuristic(pdf_w, cos_s / kPi);
          const float s = cos_s / vmax(pdf_w, 1e-20f) * w_nee / kPi;
          prad.x = prad.x + thr.x * albedo.x * (ls.le.x * s);
          prad.y = prad.y + thr.y * albedo.y * (ls.le.y * s);
          prad.z = prad.z + thr.z * albedo.z * (ls.le.z * s);
        }
      }
    }

    // --- scatter ------------------------------------------------------------
    float3 new_d, new_o;
    float pdf_cos = 0.0f;
    if (kind == kMirror) {
      new_d = sub3(d, scale3(n, 2.0f * dot3(d, n)));
      new_o = add3(p, scale3(n, a.eps));
    } else if (kind == kDielectric) {
      // exact unpolarized Fresnel split; u[0] is the R/T coin
      const float eta = h.front ? 1.0f / ior : ior;
      const float cosi = -dot3(d, n);
      const float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
      const float cost = sqrtf(vmax(kk, 0.0f));
      const float rs = (eta * cosi - cost) / vmax(eta * cosi + cost, 1e-20f);
      const float rp = (eta * cost - cosi) / vmax(eta * cost + cosi, 1e-20f);
      const float refl_p = kk <= 0.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
      if (u[0] < refl_p) {
        new_d = sub3(d, scale3(n, 2.0f * dot3(d, n)));
        new_o = add3(p, scale3(n, a.eps));
      } else {  // refracted rays continue THROUGH the surface
        new_d = add3(scale3(d, eta), scale3(n, eta * cosi - cost));
        new_o = add3(p, scale3(n, -a.eps));
      }
    } else {
      new_d = cosine_hemisphere(u[0], u[1], n, pdf_cos);
      new_o = add3(p, scale3(n, a.eps));
    }
    float3 new_thr = make_float3(thr.x * albedo.x, thr.y * albedo.y, thr.z * albedo.z);
    const float thr_max = vmax(new_thr.x, vmax(new_thr.y, new_thr.z));
    if (!(thr_max > 0.0f)) break;
    if (a.rr_start > 0 && b >= a.rr_start) {
      // Russian roulette: survive w.p. p_c, divide throughput by p_c
      const float p_c = vmin(vmax(thr_max, 0.05f), 1.0f);
      if (!(u[5] < p_c)) break;
      new_thr = scale3(new_thr, 1.0f / p_c);
    }
    thr = new_thr;
    o = new_o;
    d = new_d;
    prev_did_nee = kind == kDiffuse && sc.n_light > 0 && a.use_nee;
    prev_pdf = pdf_cos;
  }
  rad.x = rad.x + prad.x;
  rad.y = rad.y + prad.y;
  rad.z = rad.z + prad.z;
}

__global__ void __launch_bounds__(kBlockX * kBlockY) pt_kernel(const Args a) {
  extern __shared__ float tables[];
  __shared__ unsigned block_rays;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int n_sph_f = a.S * kSphW, n_tri_f = a.T * kTriW;
  const int n_mat_f = a.M * kMatW, n_light_f = a.L * kLightW;
  float* s_sph = tables;
  float* s_tri = s_sph + n_sph_f;
  float* s_mat = s_tri + n_tri_f;
  float* s_light = s_mat + n_mat_f;
  for (int i = tid; i < n_sph_f; i += kBlockX * kBlockY) s_sph[i] = __ldg(a.sph + i);
  for (int i = tid; i < n_tri_f; i += kBlockX * kBlockY) s_tri[i] = __ldg(a.tri + i);
  for (int i = tid; i < n_mat_f; i += kBlockX * kBlockY) s_mat[i] = __ldg(a.mat + i);
  for (int i = tid; i < n_light_f; i += kBlockX * kBlockY) s_light[i] = __ldg(a.light + i);
  if (tid == 0) block_rays = 0u;
  __syncthreads();

  Scene sc;
  sc.sph = s_sph;
  sc.tri = s_tri;
  sc.mat = s_mat;
  sc.light = s_light;
  sc.S = a.S;
  sc.T = a.T;
  sc.M = a.M;
  sc.L = a.L;
  sc.n_sph = min(max(__ldg(a.counts), 0), a.S);
  sc.n_tri = min(max(__ldg(a.counts + 1), 0), a.T);
  sc.n_light = min(max(__ldg(a.counts + 3), 0), a.L);
  sc.total_power = s_light[8];

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  unsigned nrays = 0u;
  if (x < a.w && y < a.h) {
    const float3 cam = make_float3(__ldg(a.cam_pos), __ldg(a.cam_pos + 1), __ldg(a.cam_pos + 2));
    const float4 q = make_float4(__ldg(a.cam_quat), __ldg(a.cam_quat + 1),
                                 __ldg(a.cam_quat + 2), __ldg(a.cam_quat + 3));
    const uint32_t px = static_cast<uint32_t>(x);
    const uint32_t py = static_cast<uint32_t>(y + a.row0);
    float3 acc = make_float3(0.0f, 0.0f, 0.0f);
    for (int s = 0; s < a.spp; ++s) {
      const uint32_t seed = static_cast<uint32_t>(a.seed) +
                            static_cast<uint32_t>(a.spp_offset + s) * kPassPrime;
      trace_pass(a, sc, px, py, seed, cam, q, acc, nrays);
    }
    const float inv = 1.0f / static_cast<float>(a.spp);
    float* out = a.out + (static_cast<size_t>(y) * a.w + x) * 3;
    out[0] = acc.x * inv;
    out[1] = acc.y * inv;
    out[2] = acc.z * inv;
  }
  // exact ray count: warp sum, one shared add per warp, one atomic per block
  const unsigned warp_sum = __reduce_add_sync(0xFFFFFFFFu, nrays);
  if ((tid & 31) == 0 && warp_sum) atomicAdd(&block_rays, warp_sum);
  __syncthreads();
  if (tid == 0 && block_rays) {
    atomicAdd(a.nrays, static_cast<unsigned long long>(block_rays));
  }
}

}  // namespace pt

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int pt_render(const pt::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (static_cast<size_t>(a->S) * pt::kSphW +
                                       static_cast<size_t>(a->T) * pt::kTriW +
                                       static_cast<size_t>(a->M) * pt::kMatW +
                                       static_cast<size_t>(a->L) * pt::kLightW);
  const dim3 grid((a->w + pt::kBlockX - 1) / pt::kBlockX,
                  (a->h + pt::kBlockY - 1) / pt::kBlockY);
  pt::pt_kernel<<<grid, dim3(pt::kBlockX, pt::kBlockY), smem,
                  static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
