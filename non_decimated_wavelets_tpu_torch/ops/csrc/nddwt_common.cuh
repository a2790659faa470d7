// What the per-level kernels (nddwt_level.cu) and the 4D stage kernels
// (nddwt_4d.cu) share: the geometry of one launch over a 3-slot view of the
// array, the float32 <-> storage conversions, the taps' copy into shared
// memory and the tile order.
//
// A slot with one tap (of 1.0) and no halo is a pass-through axis: a 2D
// level runs as (1, n0, n1), and each 4D stage keeps one slot without halo.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 76;  // db38, the longest filter the package builds
constexpr int kThreads = 256;

struct Level {
  int n[3];     // extents, slot 0 slowest
  int k[3];     // taps per slot; 1 marks the pass-through slot
  int t[3];     // output tile extents
  int left[3];  // left halo of the loaded tile
  int bit[3];   // band-index bit of each slot (band bit k = high on axis k)
  float taps[3][2][kMaxTaps];  // [slot][lo/hi][tap], already oriented
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ void copy_taps(float (*dst)[2][kMaxTaps], const Level& g) {
  for (int i = threadIdx.x; i < 3 * 2 * kMaxTaps; i += blockDim.x)
    (&dst[0][0][0])[i] = (&g.taps[0][0][0])[i];
}

// Tile origin of this CTA (tiles flattened, slot 2 fastest).
__device__ void tile_origin(const Level& g, int* b) {
  int id = blockIdx.x;
  const int n2 = (g.n[2] + g.t[2] - 1) / g.t[2];
  const int n1 = (g.n[1] + g.t[1] - 1) / g.t[1];
  b[2] = (id % n2) * g.t[2];
  id /= n2;
  b[1] = (id % n1) * g.t[1];
  b[0] = (id / n1) * g.t[0];
}

Level make_level(const int* n, const int* k, const int* t, const int* left,
                 const int* bit, const float* taps) {
  Level g;
  for (int a = 0; a < 3; ++a) {
    g.n[a] = n[a];
    g.k[a] = k[a];
    g.t[a] = t[a];
    g.left[a] = left[a];
    g.bit[a] = bit[a];
    for (int s = 0; s < 2; ++s)
      for (int j = 0; j < kMaxTaps; ++j)
        g.taps[a][s][j] = taps[(a * 2 + s) * kMaxTaps + j];
  }
  return g;
}

unsigned int num_tiles(const Level& g) {
  unsigned int c = 1;
  for (int a = 0; a < 3; ++a) c *= (g.n[a] + g.t[a] - 1) / g.t[a];
  return c;
}

}  // namespace
