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
// The halo-padded ("valid") mode: the `pad` flags mark slots whose input is
// one rank's block of a sharded axis with its ring neighbours' rows around
// it (K/2 - 1 in front and K/2 behind for the analysis, K/2 and K/2 - 1 for
// the synthesis), read without wrapping (nddwt_tile.cuh). It computes what
// the TPU kernels' concat and slab "valid" modes compute (TPU kernel table
// row 23; the slab mode's saving of the padded copy is later work):
//
//   _fused_dec_level shape=/padded=, slab_axes=/slabs= (pallas_kernels.py:776)
//   _fused_rec_level shape=/padded=, slab_axes=/slabs= (pallas_kernels.py:1468)
//   and their kernel-emitted edges, _edge_copies (pallas_kernels.py:389),
//
// called by the sharded bodies (non_decimated_wavelets_tpu/parallel/
// sharded.py:338-450); parallel/sharded.py of this package calls them the
// same way. A padded level moves the same bytes as a wrapped one, plus the
// halo rows.
//
// nddwt_dec_level: each CTA owns one output tile; the tile's body is in
// nddwt_tile.cuh, which the one-launch multilevel kernels (nddwt_multi.cu)
// share. One analysis level of a 3D array reads the array once and writes
// 2^d of them, so it is bound by device-memory bytes (9 arrays moved; at
// 256^3 f32 about 0.6 GB, ~0.18 ms at 3.35 TB/s; f64 twice that). The K-tap
// passes read shared memory K times per output, which is the next limit;
// they keep consecutive threads on consecutive addresses (no bank
// conflicts), and the depth-first tree does (2 + 4 + 8) passes' work on
// shrinking intermediates instead of 8 full band cascades.
//
// nddwt_rec_level streams slot 0 (nddwt_stream.cuh; a 2D array as
// (n0, 1, n1)): each CTA owns a (T1, T2) column on slots 1 and 2 and a
// chunk of slot 0, reads each band plane of the chunk once (plus K - 1 halo
// planes) through an asynchronous ring of window copies, runs the in-plane
// adjoint on it and scatters into a ring of K partial output planes. It
// moves the same 9 arrays as the analysis. The tile body it replaced loaded
// a (t + K - 1)^3 window per band with three divisions and three modulos
// per element, and spent its time in that loop (one more select there
// slowed the 3D pair 17.7 %); the streamed body divides nothing per
// element and reads each band about 2.2x (at 256^3 db4: its row, column and
// plane halos) instead of 4.3x. What bounds it now
// is in nddwt_stream.cuh: its copies and its passes each take about half of
// its time on an H100 and barely overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_stream.cuh"
#include "nddwt_tile.cuh"

namespace {

// kPad: the halo-padded instantiation; the wrap mode (kPad = false) runs
// the same code as before the padded mode existed.
template <typename T, bool kPad, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    dec_level_kernel(const T* __restrict__ x, T* __restrict__ big,
                     T* __restrict__ approx_out,
                     const __grid_constant__ LevelT<C> g, long long band_off,
                     C lam) {
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  dec_tile<false, kPad>(x, big, approx_out, g, taps, shared_words<C>(),
                        band_off, lam, blockIdx.x);
}

template <typename C, typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), const LevelT<C>& g, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles(g), kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool any_pad(const int* pad) { return pad && (pad[0] || pad[1] || pad[2]); }

template <typename T, typename C = compute_t<T>>
int launch_dec(const void* x, void* big, void* approx_out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const int* pad, const void* taps, long long band_off,
               double lam, cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps, pad);
  const size_t smem = tile_smem_bytes(g, false);
  auto kernel =
      any_pad(pad) ? dec_level_kernel<T, true> : dec_level_kernel<T, false>;
  return launch(kernel, g, smem, stream, (const T*)x, (T*)big, (T*)approx_out,
                g, band_off, (C)lam);
}

// The synthesis streams slot 0 (nddwt_stream.cuh): n, k, left, bit, pad
// describe the view the wrapper hands over ((n0, n1, n2) in 3D, (n0, 1, n1)
// in 2D) and t = (C, T1, T2) its chunk and plane tile.
template <typename T, typename C = compute_t<T>>
int launch_rec(const void* y, const void* approx, void* out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const int* pad, const void* taps, const StreamSources& src,
               double scale, cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps, pad);
  return launch_stream<T>((const T*)y, (const T*)approx, (T*)out, g, src, 1,
                          (C)scale, any_pad(pad), stream);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. n, k, t, left, bit, pad: 3 ints each (slot 0 slowest; n the
// output extents, pad 1 on a halo-padded slot, whose inputs then have
// extent n + k - 1; pad comes last before the stream); taps:
// 3 * 2 * 76 of the compute type (float for dtypes 0 and 1, double for 2).
// The caller makes the arrays' device current. Returns the cudaError_t of
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

extern "C" int nddwt_dec_level(const void* x, void* big, void* approx_out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, long long band_off,
                               double lam, const int* pad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dec<float>(x, big, approx_out, n, k, t, left, bit, pad,
                             taps, band_off, lam, s);
  if (dtype == 1)
    return launch_dec<__nv_bfloat16>(x, big, approx_out, n, k, t, left, bit,
                                     pad, taps, band_off, lam, s);
  if (dtype == 2)
    return launch_dec<double>(x, big, approx_out, n, k, t, left, bit, pad,
                              taps, band_off, lam, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_rec_level(const void* y, const void* approx, void* out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, const long long* band_idx,
                               double scale, const int* pad, void* stream) {
  StreamSources src;
  for (int b = 0; b < kStreamBands; ++b) src.idx[b] = b < 8 ? band_idx[b] : -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rec<float>(y, approx, out, n, k, t, left, bit, pad, taps,
                             src, scale, s);
  if (dtype == 1)
    return launch_rec<__nv_bfloat16>(y, approx, out, n, k, t, left, bit, pad,
                                     taps, src, scale, s);
  if (dtype == 2)
    return launch_rec<double>(y, approx, out, n, k, t, left, bit, pad, taps,
                              src, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
