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
// A 2D array runs as (n0, 1, n1): slot 1 is then a pass-through axis with
// one tap of 1.0 and no band split.
//
// The halo-padded ("valid") mode: the `pad` flags mark slots whose input is
// one rank's block of a sharded axis with its ring neighbours' rows around
// it (K/2 - 1 in front and K/2 behind for the analysis, K/2 and K/2 - 1 for
// the synthesis), read without wrapping (nddwt_stream.cuh). It computes what
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
// Both stream slot 0 (nddwt_stream.cuh; a 2D array as (n0, 1, n1)): each
// CTA owns a (T1, T2) column on slots 1 and 2 and a chunk of slot 0 and
// reads the planes of the chunk once (plus K - 1 halo planes) through an
// asynchronous ring of window copies. One level moves 9 arrays (at 256^3
// f32 about 0.6 GB, ~0.18 ms at 3.35 TB/s; f64 twice that).
//
// nddwt_rec_level runs a streamed synthesis: per plane the in-plane
// adjoint of its 8 bands, scattered into a ring of K partial output planes.
// The tile body it replaced loaded a (t + K - 1)^3 window per band with
// three divisions and three modulos per element and spent its time in that
// loop (one more select there slowed the 3D pair 17.7 %). 3D views with
// filters of 2 to 8 taps run the plane body (nddwt_plane.cuh: bulk copies
// of a plane's four band windows a stage, slot 1 before slot 2), the others
// the window body (nddwt_stream.cuh).
//
// nddwt_dec_level runs the streamed analysis: one window per input plane
// (the tile body copied an (11, 11, 35) window per (8, 8, 32) tile with the
// same divided, wrapped loads), the in-plane lo/hi passes depth first into
// registers, a ring of the last K planes' in-plane bands, and the 8 bands
// of each output plane written from registers. 3D views with filters of 2
// to 8 taps run the plane body (nddwt_plane.cuh: a bulk copy of each input
// plane's window a stage, slot 1 before slot 2, the in-plane bands split
// between the CTA's halves), the others the window body (nddwt_stream.cuh).
// What bounds each is in those headers and PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_plane.cuh"
#include "nddwt_stream.cuh"

namespace {

// The analysis streams slot 0 over the same view as the synthesis, t = (C,
// T1, T2), on the body the wrapper names: body 1 the plane body
// (nddwt_plane.cuh; a 3D view with one unrolled filter length, input rows on
// 16 bytes and a plan of the analysis plane body's form that fits, else
// cudaErrorInvalidValue), body 0 the window body (nddwt_stream.cuh) with gw
// in-plane bands a walk: 4 in-plane bands in 3D, 2 in 2D.
template <typename T, typename C = compute_t<T>>
int launch_dec(const void* x, void* big, void* approx_out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const int* pad, const void* taps, long long band_off,
               double lam, int gw, int body, cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps, pad);
  if (body == 1)
    return plane_ana_takes<T>(g, x)
               ? launch_plane_ana<T>((const T*)x, (T*)big, (T*)approx_out, g, band_off,
                                     (C)lam, stream)
               : (int)cudaErrorInvalidValue;
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (k[1] > 1 && k[2] > 1)
    return launch_stream_ana<T, 4>((const T*)x, (T*)big, (T*)approx_out, g, 1, gw,
                                   band_off, (C)lam, stream);
  return launch_stream_ana<T, 2>((const T*)x, (T*)big, (T*)approx_out, g, 1, gw,
                                 band_off, (C)lam, stream);
}

// The synthesis streams slot 0: n, k, left, bit, pad describe the view the
// wrapper hands over ((n0, n1, n2) in 3D, (n0, 1, n1) in 2D) and t = (C, T1,
// T2) its chunk and plane tile, on the body the wrapper names: body 1 the
// plane body (nddwt_plane.cuh; a 3D view with one unrolled filter length,
// input rows on 16 bytes and a plan of the plane body's form that fits, else
// cudaErrorInvalidValue), body 0 the window body (nddwt_stream.cuh).
template <typename T, typename C = compute_t<T>>
int launch_rec(const void* y, const void* approx, void* out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const int* pad, const void* taps, const StreamSources& src,
               double scale, int body, cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps, pad);
  if (body == 1)
    return plane_takes<T>(g, y, approx)
               ? launch_plane<T>((const T*)y, (const T*)approx, (T*)out, g, src, (C)scale,
                                 stream)
               : (int)cudaErrorInvalidValue;
  if (body != 0) return (int)cudaErrorInvalidValue;
  return launch_stream<T>((const T*)y, (const T*)approx, (T*)out, g, src, 1,
                          (C)scale, stream);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. n, k, t, left, bit, pad: 3 ints each, the streamed view
// (slot 0 slowest; n the output extents, pad 1 on a halo-padded slot, whose
// inputs then have extent n + k - 1; pad comes last before the stream); gw:
// the analysis's in-plane bands a walk; taps:
// 3 * 2 * 76 of the compute type (float for dtypes 0 and 1, double for 2);
// body: the body the launch runs, named by the wrapper (1: the plane body,
// 0: the window body).
// The caller makes the arrays' device current. Returns the cudaError_t of
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

extern "C" int nddwt_dec_level(const void* x, void* big, void* approx_out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, long long band_off,
                               double lam, int gw, const int* pad, int body,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dec<float>(x, big, approx_out, n, k, t, left, bit, pad,
                             taps, band_off, lam, gw, body, s);
  if (dtype == 1)
    return launch_dec<__nv_bfloat16>(x, big, approx_out, n, k, t, left, bit,
                                     pad, taps, band_off, lam, gw, body, s);
  if (dtype == 2)
    return launch_dec<double>(x, big, approx_out, n, k, t, left, bit, pad,
                              taps, band_off, lam, gw, body, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_rec_level(const void* y, const void* approx, void* out,
                               int dtype, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, const long long* band_idx,
                               double scale, const int* pad, int body,
                               void* stream) {
  StreamSources src;
  for (int b = 0; b < kStreamBands; ++b) src.idx[b] = b < 8 ? band_idx[b] : -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rec<float>(y, approx, out, n, k, t, left, bit, pad, taps,
                             src, scale, body, s);
  if (dtype == 1)
    return launch_rec<__nv_bfloat16>(y, approx, out, n, k, t, left, bit, pad,
                                     taps, src, scale, body, s);
  if (dtype == 2)
    return launch_rec<double>(y, approx, out, n, k, t, left, bit, pad, taps,
                              src, scale, body, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
