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
// Each CTA owns one output tile. It loads the tile's halo'd input into
// shared memory once, wrapping every index periodically (so extents smaller
// than the halo work), and runs the separable K-tap passes there, axis 0 ->
// 2, depth first: a pass's lo and hi halves are computed one after the
// other, so only one intermediate per axis is live (the shape of the TPU
// kernel's band tree, _tree_expand / _tree_reduce).
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

#include "nddwt_common.cuh"

namespace {

struct Sources {
  long long idx[8];  // band b's index into y; -1 reads the approx array
};

__device__ __forceinline__ long long wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

// The tile's (e0, e1, e2) input window starting at (o0, o1, o2), wrapped.
template <typename T, typename C>
__device__ void load_tile(C* __restrict__ s, const T* __restrict__ src,
                          const LevelT<C>& g, int o0, int o1, int o2, int e0,
                          int e1, int e2) {
  const int total = e0 * e1 * e2;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l2 = i % e2;
    const int r = i / e2;
    const int l1 = r % e1;
    const int l0 = r / e1;
    const long long g0 = wrap(o0 + l0, g.n[0]);
    const long long g1 = wrap(o1 + l1, g.n[1]);
    const long long g2 = wrap(o2 + l2, g.n[2]);
    s[i] = to_f(src[(g0 * g.n[1] + g1) * g.n[2] + g2]);
  }
}

// out = K-tap correlation of `in` (d0, d1, d2) along axis A, keeping `to`
// outputs on that axis: out[c] = sum_j tp[j] * in[c + j e_A].
template <int A, bool ACCUM, typename C>
__device__ void pass(C* __restrict__ out, const C* __restrict__ in,
                     int d0, int d1, int d2, int to,
                     const C* __restrict__ tp, int K) {
  const int o0 = A == 0 ? to : d0;
  const int o1 = A == 1 ? to : d1;
  const int o2 = A == 2 ? to : d2;
  const int stride = A == 2 ? 1 : (A == 1 ? d2 : d1 * d2);
  const int total = o0 * o1 * o2;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c2 = i % o2;
    const int r = i / o2;
    const int c1 = r % o1;
    const int c0 = r / o1;
    const C* p = in + (c0 * d1 + c1) * d2 + c2;
    C acc = 0;
    for (int j = 0; j < K; ++j) acc = mad(tp[j], p[j * stride], acc);
    if (ACCUM)
      out[i] += acc;
    else
      out[i] = acc;
  }
}

// Analysis: writes detail band b (b >= 1) to big[band_off + b - 1] and
// band 0 to approx_out (the next approximation, or big[0] at the final
// level). lam > 0 soft-thresholds the details in registers.
template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    dec_level_kernel(const T* __restrict__ x, T* __restrict__ big,
                     T* __restrict__ approx_out,
                     const __grid_constant__ LevelT<C> g, long long band_off,
                     C lam) {
  C* smem = shared_words<C>();
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  int b[3];
  tile_origin(g, b);
  const int t0 = g.t[0], t1 = g.t[1], t2 = g.t[2];
  const int e0 = t0 + g.k[0] - 1, e1 = t1 + g.k[1] - 1, e2 = t2 + g.k[2] - 1;
  C* s0 = smem;               // (e0, e1, e2) input tile
  C* p1 = s0 + e0 * e1 * e2;  // (t0, e1, e2) after axis 0
  C* p2 = p1 + t0 * e1 * e2;  // (t0, t1, e2) after axis 1
  load_tile(s0, x, g, b[0] - g.left[0], b[1] - g.left[1], b[2] - g.left[2],
            e0, e1, e2);
  __syncthreads();

  const long long vox = (long long)g.n[0] * g.n[1] * g.n[2];
  const int ns0 = g.k[0] > 1 ? 2 : 1;
  const int ns1 = g.k[1] > 1 ? 2 : 1;
  for (int s0i = 0; s0i < ns0; ++s0i) {
    pass<0, false>(p1, s0, e0, e1, e2, t0, taps[0][s0i], g.k[0]);
    __syncthreads();
    for (int s1i = 0; s1i < ns1; ++s1i) {
      pass<1, false>(p2, p1, t0, e1, e2, t1, taps[1][s1i], g.k[1]);
      __syncthreads();
      for (int s2i = 0; s2i < 2; ++s2i) {
        const int band =
            (s0i << g.bit[0]) | (s1i << g.bit[1]) | (s2i << g.bit[2]);
        T* dst = band == 0 ? approx_out : big + (band_off + band - 1) * vox;
        const bool shrunk = band != 0 && lam > 0;
        const C* tp = taps[2][s2i];
        for (int i = threadIdx.x; i < t0 * t1 * t2; i += blockDim.x) {
          const int c2 = i % t2;
          const int r = i / t2;
          const int c1 = r % t1;
          const int c0 = r / t1;
          const int q0 = b[0] + c0, q1 = b[1] + c1, q2 = b[2] + c2;
          if (q0 >= g.n[0] || q1 >= g.n[1] || q2 >= g.n[2]) continue;
          const C* p = p2 + (c0 * t1 + c1) * e2 + c2;
          C acc = 0;
          for (int j = 0; j < g.k[2]; ++j) acc = mad(tp[j], p[j], acc);
          if (shrunk) acc = shrink(acc, lam);
          dst[((long long)q0 * g.n[1] + q1) * g.n[2] + q2] = from_f<T>(acc);
        }
      }
      __syncthreads();  // p2 is rewritten by the next axis-1 pass
    }
  }
}

// Synthesis: out = scale * sum_b adjoint_b(band b), band b read from
// y[src.idx[b]] or from approx. The taps arrive reversed, so the adjoint is
// the same forward correlation over a tile with the mirrored halo.
template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    rec_level_kernel(const T* __restrict__ y, const T* __restrict__ approx,
                     T* __restrict__ out, const __grid_constant__ LevelT<C> g,
                     const __grid_constant__ Sources src, C scale) {
  C* smem = shared_words<C>();
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  int b[3];
  tile_origin(g, b);
  const int t0 = g.t[0], t1 = g.t[1], t2 = g.t[2];
  const int e0 = t0 + g.k[0] - 1, e1 = t1 + g.k[1] - 1, e2 = t2 + g.k[2] - 1;
  C* s0 = smem;               // (e0, e1, e2) one band's tile
  C* p1 = s0 + e0 * e1 * e2;  // (t0, e1, e2) sum over the axis-0 bit
  C* p2 = p1 + t0 * e1 * e2;  // (t0, t1, e2) sum over the axis-1 bit
  C* acc = p2 + t0 * t1 * e2; // (t0, t1, t2) the output tile
  const long long vox = (long long)g.n[0] * g.n[1] * g.n[2];
  const int ns0 = g.k[0] > 1 ? 2 : 1;
  const int ns1 = g.k[1] > 1 ? 2 : 1;
  const int p1n = t0 * e1 * e2, p2n = t0 * t1 * e2, an = t0 * t1 * t2;

  for (int i = threadIdx.x; i < an; i += blockDim.x) acc[i] = 0;
  for (int s2i = 0; s2i < 2; ++s2i) {
    for (int i = threadIdx.x; i < p2n; i += blockDim.x) p2[i] = 0;
    for (int s1i = 0; s1i < ns1; ++s1i) {
      for (int i = threadIdx.x; i < p1n; i += blockDim.x) p1[i] = 0;
      for (int s0i = 0; s0i < ns0; ++s0i) {
        const int band =
            (s0i << g.bit[0]) | (s1i << g.bit[1]) | (s2i << g.bit[2]);
        const long long idx = src.idx[band];
        const T* bsrc = idx < 0 ? approx : y + idx * vox;
        __syncthreads();  // the previous band's tile is consumed
        load_tile(s0, bsrc, g, b[0] - g.left[0], b[1] - g.left[1],
                  b[2] - g.left[2], e0, e1, e2);
        __syncthreads();
        pass<0, true>(p1, s0, e0, e1, e2, t0, taps[0][s0i], g.k[0]);
      }
      __syncthreads();
      pass<1, true>(p2, p1, t0, e1, e2, t1, taps[1][s1i], g.k[1]);
      __syncthreads();
    }
    pass<2, true>(acc, p2, t0, t1, e2, t2, taps[2][s2i], g.k[2]);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < an; i += blockDim.x) {
    const int c2 = i % t2;
    const int r = i / t2;
    const int c1 = r % t1;
    const int c0 = r / t1;
    const int q0 = b[0] + c0, q1 = b[1] + c1, q2 = b[2] + c2;
    if (q0 >= g.n[0] || q1 >= g.n[1] || q2 >= g.n[2]) continue;
    out[((long long)q0 * g.n[1] + q1) * g.n[2] + q2] = from_f<T>(acc[i] * scale);
  }
}

template <typename C>
size_t smem_bytes(const LevelT<C>& g, bool rec) {
  const size_t e0 = g.t[0] + g.k[0] - 1, e1 = g.t[1] + g.k[1] - 1,
               e2 = g.t[2] + g.k[2] - 1;
  size_t w = e0 * e1 * e2 + g.t[0] * e1 * e2 + (size_t)g.t[0] * g.t[1] * e2;
  if (rec) w += (size_t)g.t[0] * g.t[1] * g.t[2];
  return w * sizeof(C);
}

template <typename T, typename C = compute_t<T>>
int launch_dec(const void* x, void* big, void* approx_out, const int* n,
               const int* k, const int* t, const int* left, const int* bit,
               const void* taps, long long band_off, double lam,
               cudaStream_t stream) {
  const LevelT<C> g = make_level<C>(n, k, t, left, bit, taps);
  const size_t smem = smem_bytes(g, false);
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
  const size_t smem = smem_bytes(g, true);
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
