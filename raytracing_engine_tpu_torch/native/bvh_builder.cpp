// Native BVH builder — the host-side heavy lifting for big meshes.
// A copy of raytracing_engine_tpu/native/bvh_builder.cpp: host code, not a
// device kernel.
//
// Produces the exact array layout consumed by accel/bvh.py (DFS preorder,
// skip links, leaf ranges into a reordered triangle array); the numpy
// builder is the reference implementation, this one is for 100k..1M+
// triangle scenes (BASELINE configs 3/5) where Python recursion is too slow.
//
// C ABI only (loaded via ctypes by native/loader.py).
//
// Build (native/loader.py, at first use):
//   g++ -O3 -fPIC -shared -std=c++17 bvh_builder.cpp -o libbvh_builder.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kSahBins = 16;

struct BuildCtx {
  const float* tris;  // (T, 9): v0 v1 v2
  int leaf_size;
  int method;         // 0 = median, 1 = binned SAH
  // outputs
  float* bb_min;      // (cap, 3)
  float* bb_max;      // (cap, 3)
  int32_t* first;     // (cap,)
  int32_t* count;     // (cap,)
  int32_t* skip;      // (cap,)
  int32_t* perm;      // (T,)
  int64_t n_nodes = 0;
  int64_t n_out = 0;
  int64_t cap;
  std::vector<float> cen;   // (T, 3) centroids
  std::vector<float> tlo;   // (T, 3) per-tri bbox
  std::vector<float> thi;
};

// returns node index, or -1 on capacity overflow
int64_t build(BuildCtx& c, int32_t* ids, int64_t n) {
  if (c.n_nodes >= c.cap) return -1;
  int64_t node = c.n_nodes++;

  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    const float* l = &c.tlo[3 * ids[i]];
    const float* h = &c.thi[3 * ids[i]];
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], l[k]);
      hi[k] = std::max(hi[k], h[k]);
    }
  }
  std::memcpy(&c.bb_min[3 * node], lo, 12);
  std::memcpy(&c.bb_max[3 * node], hi, 12);

  if (n <= c.leaf_size) {
    c.first[node] = (int32_t)c.n_out;
    c.count[node] = (int32_t)n;
    for (int64_t i = 0; i < n; ++i) c.perm[c.n_out++] = ids[i];
  } else {
    c.first[node] = -1;
    c.count[node] = 0;
    // longest centroid axis
    float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n; ++i) {
      const float* p = &c.cen[3 * ids[i]];
      for (int k = 0; k < 3; ++k) {
        clo[k] = std::min(clo[k], p[k]);
        chi[k] = std::max(chi[k], p[k]);
      }
    }
    int axis = 0;
    float best = chi[0] - clo[0];
    for (int k = 1; k < 3; ++k)
      if (chi[k] - clo[k] > best) { best = chi[k] - clo[k]; axis = k; }

    // left-count after partitioning; default = median split
    int64_t nl = -1;
    if (c.method == 1 && best > 0.0f) {
      // binned SAH on the longest centroid axis: min over split planes of
      // A_left*N_left + A_right*N_right (always splitting while
      // n > leaf_size, so leaf/traversal constants drop out)
      const float scale = (float)kSahBins / best;
      int64_t cnt[kSahBins] = {0};
      float blo[kSahBins][3], bhi[kSahBins][3];
      for (int b = 0; b < kSahBins; ++b)
        for (int k = 0; k < 3; ++k) { blo[b][k] = 1e30f; bhi[b][k] = -1e30f; }
      auto bin_of = [&](int32_t id) {
        int b = (int)((c.cen[3 * id + axis] - clo[axis]) * scale);
        return b < 0 ? 0 : (b >= kSahBins ? kSahBins - 1 : b);
      };
      for (int64_t i = 0; i < n; ++i) {
        int b = bin_of(ids[i]);
        ++cnt[b];
        for (int k = 0; k < 3; ++k) {
          blo[b][k] = std::min(blo[b][k], c.tlo[3 * ids[i] + k]);
          bhi[b][k] = std::max(bhi[b][k], c.thi[3 * ids[i] + k]);
        }
      }
      auto half_area = [](const float* l, const float* h) {
        float d0 = std::max(h[0] - l[0], 0.0f);
        float d1 = std::max(h[1] - l[1], 0.0f);
        float d2 = std::max(h[2] - l[2], 0.0f);
        return d0 * d1 + d1 * d2 + d2 * d0;
      };
      // suffix (right-side) union areas per split plane
      float rarea[kSahBins] = {0};
      {
        float rl[3] = {1e30f, 1e30f, 1e30f}, rh[3] = {-1e30f, -1e30f, -1e30f};
        for (int b = kSahBins - 1; b >= 1; --b) {
          for (int k = 0; k < 3; ++k) {
            rl[k] = std::min(rl[k], blo[b][k]);
            rh[k] = std::max(rh[k], bhi[b][k]);
          }
          rarea[b] = half_area(rl, rh);
        }
      }
      double best_cost = 1e300;
      int best_plane = -1;  // split between bin b and b+1
      float ll[3] = {1e30f, 1e30f, 1e30f}, lh[3] = {-1e30f, -1e30f, -1e30f};
      int64_t cl = 0;
      for (int b = 0; b < kSahBins - 1; ++b) {
        for (int k = 0; k < 3; ++k) {
          ll[k] = std::min(ll[k], blo[b][k]);
          lh[k] = std::max(lh[k], bhi[b][k]);
        }
        cl += cnt[b];
        int64_t cr = n - cl;
        if (cl == 0 || cr == 0) continue;
        double cost = (double)half_area(ll, lh) * cl + (double)rarea[b + 1] * cr;
        if (cost < best_cost) { best_cost = cost; best_plane = b; }
      }
      if (best_plane >= 0) {
        int32_t* mid = std::partition(ids, ids + n, [&](int32_t id) {
          return bin_of(id) <= best_plane;
        });
        nl = mid - ids;
      }
    }
    if (nl <= 0 || nl >= n) {  // median fallback (degenerate centroids)
      nl = n / 2;
      std::nth_element(ids, ids + nl, ids + n, [&](int32_t a, int32_t b) {
        return c.cen[3 * a + axis] < c.cen[3 * b + axis];
      });
    }
    if (build(c, ids, nl) < 0) return -1;
    if (build(c, ids + nl, n - nl) < 0) return -1;
  }
  c.skip[node] = (int32_t)c.n_nodes;
  return node;
}

}  // namespace

extern "C" {

// Returns number of nodes, or -1 if node capacity `cap` was insufficient.
// method: 0 = median split, 1 = binned SAH (16 bins, longest centroid axis).
int64_t bvh_build(const float* tris, int64_t T, int leaf_size, int64_t cap,
                  float* bb_min, float* bb_max, int32_t* first,
                  int32_t* count, int32_t* skip, int32_t* perm, int method) {
  BuildCtx c;
  c.tris = tris;
  c.leaf_size = leaf_size;
  c.method = method;
  c.cap = cap;
  c.bb_min = bb_min;
  c.bb_max = bb_max;
  c.first = first;
  c.count = count;
  c.skip = skip;
  c.perm = perm;
  c.cen.resize(3 * T);
  c.tlo.resize(3 * T);
  c.thi.resize(3 * T);
  for (int64_t i = 0; i < T; ++i) {
    for (int k = 0; k < 3; ++k) {
      float a = tris[9 * i + k], b = tris[9 * i + 3 + k], d = tris[9 * i + 6 + k];
      float lo = std::min(a, std::min(b, d));
      float hi = std::max(a, std::max(b, d));
      c.tlo[3 * i + k] = lo;
      c.thi[3 * i + k] = hi;
      c.cen[3 * i + k] = 0.5f * (lo + hi);
    }
  }
  std::vector<int32_t> ids(T);
  for (int64_t i = 0; i < T; ++i) ids[i] = (int32_t)i;
  if (build(c, ids.data(), T) < 0) return -1;
  return c.n_nodes;
}

}  // extern "C"
