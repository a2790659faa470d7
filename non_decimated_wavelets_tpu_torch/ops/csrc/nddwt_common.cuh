// What the per-level kernels (nddwt_level.cu, nddwt_stream.cuh), the 4D
// stage kernels (nddwt_4d.cu) and the multilevel kernels (nddwt_multi.cu)
// share: the geometry of one launch over a 3-slot view of the array, the
// storage <-> compute conversions, the taps' copy into shared memory and
// the tile order.
//
// Every kernel has a storage type T and a compute type C = compute_t<T>:
// float for float and bfloat16 storage, double for double. The taps of a
// launch arrive in C, so a float64 level correlates with float64 taps.
//
// A slot with one tap (of 1.0) and no halo is a pass-through axis: a 2D
// level runs as (1, n0, n1), and each 4D stage keeps one slot without halo.
//
// A halo-padded slot (pad = 1) is one rank's block of an axis sharded over
// several ranks: its input carries the ring neighbours' rows, `left` in
// front of output row 0 and k - 1 - left behind row n - 1 (extent
// n + k - 1), and is read without wrapping. The outputs keep extent n.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 76;  // db38, the longest filter the package builds
constexpr int kThreads = 256;

template <typename T>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};
template <typename T>
using compute_t = typename Compute<T>::type;

template <typename C>
struct LevelT {
  int n[3];     // extents, slot 0 slowest
  int k[3];     // taps per slot; 1 marks the pass-through slot
  int t[3];     // output tile extents
  int left[3];  // left halo of the loaded tile
  int bit[3];   // band-index bit of each slot (band bit k = high on axis k)
  int pad[3];   // 1: the input is halo-padded on this slot (extent n + k - 1)
  C taps[3][2][kMaxTaps];  // [slot][lo/hi][tap], already oriented
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_f(double v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(compute_t<T> v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ double from_f<double>(double v) { return v; }

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// v * max(|v| - lam, 0) / max(|v|, 1e-30): the soft threshold of a detail.
__device__ __forceinline__ float shrink(float v, float lam) {
  const float m = fabsf(v);
  return v * (fmaxf(m - lam, 0.f) / fmaxf(m, 1e-30f));
}
__device__ __forceinline__ double shrink(double v, double lam) {
  const double m = fabs(v);
  return v * (fmax(m - lam, 0.0) / fmax(m, 1e-30));
}

template <typename C>
__device__ void copy_taps(C (*dst)[2][kMaxTaps], const LevelT<C>& g) {
  for (int i = threadIdx.x; i < 3 * 2 * kMaxTaps; i += blockDim.x)
    (&dst[0][0][0])[i] = (&g.taps[0][0][0])[i];
}

// Origin of tile `id` (tiles flattened, slot 2 fastest).
template <typename C>
__device__ void tile_origin(const LevelT<C>& g, unsigned int id, int* b) {
  const int n2 = (g.n[2] + g.t[2] - 1) / g.t[2];
  const int n1 = (g.n[1] + g.t[1] - 1) / g.t[1];
  b[2] = (id % n2) * g.t[2];
  id /= n2;
  b[1] = (id % n1) * g.t[1];
  b[0] = (id / n1) * g.t[0];
}

// Tile origin of this CTA: one tile per CTA.
template <typename C>
__device__ void tile_origin(const LevelT<C>& g, int* b) {
  tile_origin(g, blockIdx.x, b);
}

// pad == nullptr: no slot is halo-padded (every index wraps).
template <typename C>
LevelT<C> make_level(const int* n, const int* k, const int* t, const int* left,
                     const int* bit, const void* taps,
                     const int* pad = nullptr) {
  const C* tp = static_cast<const C*>(taps);
  LevelT<C> g;
  for (int a = 0; a < 3; ++a) {
    g.n[a] = n[a];
    g.k[a] = k[a];
    g.t[a] = t[a];
    g.left[a] = left[a];
    g.bit[a] = bit[a];
    g.pad[a] = pad ? pad[a] : 0;
    for (int s = 0; s < 2; ++s)
      for (int j = 0; j < kMaxTaps; ++j)
        g.taps[a][s][j] = tp[(a * 2 + s) * kMaxTaps + j];
  }
  return g;
}

// Extent of slot a of the input: n, or n + k - 1 on a halo-padded slot.
template <typename C>
__host__ __device__ __forceinline__ int in_extent(const LevelT<C>& g, int a) {
  return g.pad[a] ? g.n[a] + g.k[a] - 1 : g.n[a];
}

// Elements of one input array (one band of a band array).
template <typename C>
__host__ __device__ __forceinline__ long long in_vox(const LevelT<C>& g) {
  return (long long)in_extent(g, 0) * in_extent(g, 1) * in_extent(g, 2);
}

template <typename C>
__host__ __device__ unsigned int num_tiles(const LevelT<C>& g) {
  unsigned int c = 1;
  for (int a = 0; a < 3; ++a) c *= (g.n[a] + g.t[a] - 1) / g.t[a];
  return c;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply-high, an add and a
// shift (Granlund and Montgomery); make_div computes the magic number, once
// per divisor, on the host or the device.
struct FastDiv {
  unsigned d, m, s;
};

__host__ __device__ inline FastDiv make_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
#ifdef __CUDA_ARCH__
  f.s = d > 1 ? 32 - __clz(d - 1) : 0;
#else
  while ((1ull << f.s) < d) ++f.s;
#endif
  f.m = (unsigned)(((1ull << 32) * ((1ull << f.s) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ int fdiv(const FastDiv& f, int n) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.s);
}

// The dynamic shared memory of a kernel over compute type C, typed: one
// extern array for every instantiation (two extern arrays of different
// types in one translation unit would conflict).
template <typename C>
__device__ __forceinline__ C* shared_words() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<C*>(smem_raw);
}

}  // namespace
