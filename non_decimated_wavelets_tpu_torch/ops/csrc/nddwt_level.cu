// One level of the multilevel non-decimated DWT, hand-written for Hopper.
//
//   nddwt_dec_level  replaces the TPU kernel _make_dec_kernel / _fused_dec_level
//                    (non_decimated_wavelets_tpu/ops/pallas_kernels.py:519,776)
//   nddwt_rec_level  replaces the TPU kernel _make_rec_kernel / _fused_rec_level
//                    (non_decimated_wavelets_tpu/ops/pallas_kernels.py:1389,1468)
//
// Both work on 2D and 3D arrays of float or bfloat16, computing in float32
// with float32 taps, and of double, computing in float64 with float64 taps
// and fma. The double instantiations replace the TPU's float64-accurate
// levels, which emulate float64 with pairs of float32 (error-free sums and
// products; Hopper has float64 units):
//
//   nddwt_dec_level  (double) replaces _make_dec_kernel_df / _dec_level_df
//                    (non_decimated_wavelets_tpu/ops/pallas_df32.py:271,334)
//   nddwt_rec_level  (double) replaces _make_rec_kernel_df / _rec_level_df
//                    (non_decimated_wavelets_tpu/ops/pallas_df32.py:392,494)
//
// A 2D array runs as (1, n0, n1): slot 0 is then a pass-through axis with
// one tap of 1.0 and no band split.
//
// Each CTA owns one output tile; the tile's body is in nddwt_tile.cuh, which
// the one-launch multilevel kernels (nddwt_multi.cu) share.
//
// What bounds them: one analysis level of a 3D array reads the array once and
// writes 2^d of them, so it is bound by device-memory bytes (9 arrays moved;
// at 256^3 f32 about 0.6 GB, ~0.18 ms at 3.35 TB/s; f64 twice that). The K-tap passes
// read shared memory K times per output, which is the next limit; they keep
// consecutive threads on consecutive addresses (no bank conflicts), and the
// depth-first tree does (2 + 4 + 8) passes' work on shrinking intermediates
// instead of 8 full band cascades. TMA, wgmma and warp specialisation are
// left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_tile.cuh"

namespace {

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    dec_level_kernel(const T* __restrict__ x, T* __restrict__ big,
                     T* __restrict__ approx_out,
                     const __grid_constant__ LevelT<C> g, long long band_off,
                     C lam) {
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  dec_tile<false>(x, big, approx_out, g, taps, shared_words<C>(), band_off,
                  lam, blockIdx.x);
}

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    rec_level_kernel(const T* __restrict__ y, const T* __restrict__ approx,
                     T* __restrict__ out, const __grid_constant__ LevelT<C> g,
                     const __grid_constant__ Sources src, C scale) {
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  rec_tile<false>(y, approx, out, g, src, scale, taps, shared_words<C>(),
                  blockIdx.x);
}

template <typename T, typename C = compute_t<T>>
int launch_dec(const void* x, void* big, void* approx_out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const void* taps, long long band_off, double lam,
               cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps);
  const size_t smem = tile_smem_bytes(g, false);
  cudaError_t e = cudaFuncSetAttribute(
      dec_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dec_level_kernel<T><<<num_tiles(g), kThreads, smem, stream>>>(
      (const T*)x, (T*)big, (T*)approx_out, g, band_off, (C)lam);
  return (int)cudaGetLastError();
}

template <typename T, typename C = compute_t<T>>
int launch_rec(const void* y, const void* approx, void* out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const void* taps, const Sources& src, double scale,
               cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps);
  const size_t smem = tile_smem_bytes(g, true);
  cudaError_t e = cudaFuncSetAttribute(
      rec_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rec_level_kernel<T><<<num_tiles(g), kThreads, smem, stream>>>(
      (const T*)y, (const T*)approx, (T*)out, g, src, (C)scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. n, k, t, left, bit: 3 ints each (slot 0 slowest); taps:
// 3 * 2 * 76 of the compute type (float for dtypes 0 and 1, double for 2).
// The caller makes the arrays' device current. Returns the cudaError_t of
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

extern "C" int nddwt_dec_level(const void* x, void* big, void* approx_out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, long long band_off,
                               double lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dec<float>(x, big, approx_out, n, k, t, left, bit, taps,
                             band_off, lam, s);
  if (dtype == 1)
    return launch_dec<__nv_bfloat16>(x, big, approx_out, n, k, t, left, bit,
                                     taps, band_off, lam, s);
  if (dtype == 2)
    return launch_dec<double>(x, big, approx_out, n, k, t, left, bit, taps,
                              band_off, lam, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_rec_level(const void* y, const void* approx, void* out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, const long long* band_idx,
                               double scale, void* stream) {
  Sources src;
  for (int b = 0; b < 8; ++b) src.idx[b] = band_idx[b];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rec<float>(y, approx, out, n, k, t, left, bit, taps, src,
                             scale, s);
  if (dtype == 1)
    return launch_rec<__nv_bfloat16>(y, approx, out, n, k, t, left, bit, taps,
                                     src, scale, s);
  if (dtype == 2)
    return launch_rec<double>(y, approx, out, n, k, t, left, bit, taps, src,
                              scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
