// K4 and K5 with the light features (pt.cuh kLights), and their C entry
// points (bound with ctypes by ops/cuda/pt.py and ops/cuda/common.py): the
// light forms, which replace _pt_kernel and _pt_rebin_kernel
// (raytracing_engine_tpu/ops/pallas/pt_kernel.py:194-212: has_mlt,
// has_ltree, has_lmlt and the fog of cfg) where a render has homogeneous
// fog and single-scatter media, the light tree, or mesh lights one triangle
// a pass (K4 reads pass s's row of Args.mesh_rows, K5 its launch's row) or
// one a lane. Each feature is a run-time flag of these forms, which hold
// the sampling features too (the thin lens, R_d, K4's adaptive passes: the
// cell update between them is pt.cu's pt_adapt). One light form for each
// instantiation of pt.cu's (the mesh kinds, kMat, kTex), so the renders
// without the light features launch the code they launched before; a
// source of its own, so that nvcc builds it beside pt.cu.
//
// Build: as pt.cu.
#include "pt_body.cuh"

namespace pt {

template <int kMesh, bool kMat>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_lights_kernel(const Args a) {
  pt_body<kMesh, kMat, false, true, true>(a);
}
template <int kMesh>
__global__ void __launch_bounds__(K4<kMesh>::kThreads) pt_lights_tex_kernel(const Args a) {
  pt_body<kMesh, true, true, true, true>(a);
}

template <bool kMat>
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_lights_kernel(const Args a) {
  pt_rebin_body<kMat, false, true, true>(a);
}
__global__ void __launch_bounds__(kRebinThreads) pt_rebin_lights_tex_kernel(const Args a) {
  pt_rebin_body<true, true, true, true>(a);
}

// K4's light form at mesh kind kMesh: the texture instantiation where the
// scene has the texture features, else the material one where it has any
// of the material features.
template <int kMesh>
cudaError_t launch_pt_lights(const Args* a, cudaStream_t stream) {
  using B = K4<kMesh>;
  const dim3 grid((a->w + B::kBlockX - 1) / B::kBlockX, (a->h + B::kBlockY - 1) / B::kBlockY);
  const dim3 block(B::kBlockX, B::kBlockY);
  const size_t smem = table_bytes(a);
  if (a->tex) {
    pt_lights_tex_kernel<kMesh><<<grid, block, smem, stream>>>(*a);
  } else if (a->material) {
    pt_lights_kernel<kMesh, true><<<grid, block, smem, stream>>>(*a);
  } else {
    pt_lights_kernel<kMesh, false><<<grid, block, smem, stream>>>(*a);
  }
  return cudaGetLastError();
}

}  // namespace pt

// Launch K4's light form on `stream` (a cudaStream_t), its instantiation for
// the mesh kind of the tables it is given; does not synchronise, and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int pt_lights_render(const pt::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->cl.trec == nullptr) return static_cast<int>(pt::launch_pt_lights<pt::kMeshNone>(a, s));
  if (a->inst.tab == nullptr) {
    return static_cast<int>(pt::launch_pt_lights<pt::kMeshClusters>(a, s));
  }
  return static_cast<int>(pt::launch_pt_lights<pt::kMeshInstances>(a, s));
}

// Launch K5's light form (bounce a->bounce over a->state) on `stream`; as
// pt_lights_render.
extern "C" int pt_lights_rebin(const pt::Args* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n_state > 0) {
    const dim3 grid((a->n_state + pt::kRebinThreads - 1) / pt::kRebinThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = pt::table_bytes(a);
    if (a->tex) {
      pt::pt_rebin_lights_tex_kernel<<<grid, pt::kRebinThreads, smem, s>>>(*a);
    } else if (a->material) {
      pt::pt_rebin_lights_kernel<true><<<grid, pt::kRebinThreads, smem, s>>>(*a);
    } else {
      pt::pt_rebin_lights_kernel<false><<<grid, pt::kRebinThreads, smem, s>>>(*a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_lights_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
