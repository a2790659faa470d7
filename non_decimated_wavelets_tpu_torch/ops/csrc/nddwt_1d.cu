// One level of the 1D multilevel non-decimated DWT, hand-written for Hopper.
//
//   nddwt_dec1_level  replaces the TPU kernel _dec1_level
//                     (non_decimated_wavelets_tpu/ops/pallas_padded.py:501)
//   nddwt_rec1_level  replaces the TPU kernel _rec1_level
//                     (non_decimated_wavelets_tpu/ops/pallas_padded.py:572)
//
// Analysis: the approximation x (N,) gives lo[q] = sum_j tl[j] x[q + j - L]
// and hi[q] = sum_j th[j] x[q + j - L], indices mod N, L = K/2 - 1. hi is
// the level's detail band (soft-thresholded when lam > 0), lo the next
// approximation (or band 0 at the final level). Synthesis: out[q] = scale *
// sum_j (rl[j] a[q + j - L] + rh[j] d[q + j - L]) with the taps reversed and
// the halo mirrored (L = K/2): the adjoint of the analysis on the
// approximation a and one detail band d.
//
// float and bfloat16 storage compute in float32 with float32 taps, double
// in float64 with float64 taps and fma. Any N >= 1 works (the TPU version
// needs N >= 1024 and K <= 1024): every index wraps.
//
// Each CTA owns a chunk of kChunk outputs. It loads the chunk's window,
// chunk + K - 1 samples, into shared memory with consecutive threads on
// consecutive addresses (the wrap costs a modulo only in the chunks that
// cross the ends of the signal), then each thread runs the K taps for
// kChunk / kThreads outputs out of shared memory, consecutive threads on
// consecutive words. This replaces the TPU's 1024-sample wrap extension of
// the signal (one concatenation per level in device memory) and its chains
// of lane and sublane shifts.
//
// What bounds them: device-memory bytes. A level reads one array and writes
// two (analysis) or reads two and writes one (synthesis): at N = 2^23 float32
// 100.7 MB, 0.030 ms at 3.35 TB/s (0.060 ms in float64), against 2K
// multiply-adds per output (db6: 0.40 GFLOP, 0.006 ms at 67 TFLOP/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_common.cuh"

namespace {

constexpr int kChunk = 2048;  // outputs per CTA, 8 per thread

template <typename C>
struct Taps1 {
  C t[2][kMaxTaps];  // [lo/hi][tap], already oriented
};

// s[i] = src[(start + i) mod n] for i < w.
template <typename T, typename C>
__device__ void load_window1(C* __restrict__ s, const T* __restrict__ src,
                             long long n, long long start, int w) {
  if (start >= 0 && start + w <= n) {
    for (int i = threadIdx.x; i < w; i += blockDim.x) s[i] = to_f(src[start + i]);
  } else {
    long long m = start % n;
    if (m < 0) m += n;
    for (int i = threadIdx.x; i < w; i += blockDim.x) s[i] = to_f(src[(m + i) % n]);
  }
}

template <typename C>
__device__ void copy_taps1(C (*dst)[kMaxTaps], const Taps1<C>& tp) {
  for (int i = threadIdx.x; i < 2 * kMaxTaps; i += blockDim.x)
    (&dst[0][0])[i] = (&tp.t[0][0])[i];
}

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    dec1_level_kernel(const T* __restrict__ x, T* __restrict__ detail,
                      T* __restrict__ approx_out, long long n, int K, int left,
                      const __grid_constant__ Taps1<C> tp, C lam) {
  C* s = shared_words<C>();
  __shared__ C taps[2][kMaxTaps];
  copy_taps1(taps, tp);
  const long long c0 = (long long)blockIdx.x * kChunk;
  load_window1(s, x, n, c0 - left, kChunk + K - 1);
  __syncthreads();
  const bool shrunk = lam > 0;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const long long q = c0 + i;
    if (q >= n) break;
    const C* p = s + i;
    C lo = 0, hi = 0;
    for (int j = 0; j < K; ++j) {
      const C v = p[j];
      lo = mad(taps[0][j], v, lo);
      hi = mad(taps[1][j], v, hi);
    }
    approx_out[q] = from_f<T>(lo);
    detail[q] = from_f<T>(shrunk ? shrink(hi, lam) : hi);
  }
}

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    rec1_level_kernel(const T* __restrict__ a, const T* __restrict__ d,
                      T* __restrict__ out, long long n, int K, int left,
                      const __grid_constant__ Taps1<C> tp, C scale) {
  C* sa = shared_words<C>();
  const int w = kChunk + K - 1;
  C* sd = sa + w;
  __shared__ C taps[2][kMaxTaps];
  copy_taps1(taps, tp);
  const long long c0 = (long long)blockIdx.x * kChunk;
  load_window1(sa, a, n, c0 - left, w);
  load_window1(sd, d, n, c0 - left, w);
  __syncthreads();
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const long long q = c0 + i;
    if (q >= n) break;
    C acc = 0;
    for (int j = 0; j < K; ++j) {
      acc = mad(taps[0][j], sa[i + j], acc);
      acc = mad(taps[1][j], sd[i + j], acc);
    }
    out[q] = from_f<T>(acc * scale);
  }
}

template <typename C>
Taps1<C> make_taps1(const void* taps) {
  const C* tp = static_cast<const C*>(taps);
  Taps1<C> t;
  for (int s = 0; s < 2; ++s)
    for (int j = 0; j < kMaxTaps; ++j) t.t[s][j] = tp[s * kMaxTaps + j];
  return t;
}

unsigned int num_chunks(long long n) {
  return (unsigned int)((n + kChunk - 1) / kChunk);
}

template <typename T, typename C = compute_t<T>>
int launch_dec1(const void* x, void* detail, void* approx_out, long long n,
                int k, int left, const void* taps, double lam,
                cudaStream_t stream) {
  const size_t smem = (size_t)(kChunk + k - 1) * sizeof(C);  // under 48 KB
  dec1_level_kernel<T, C><<<num_chunks(n), kThreads, smem, stream>>>(
      (const T*)x, (T*)detail, (T*)approx_out, n, k, left, make_taps1<C>(taps),
      (C)lam);
  return (int)cudaGetLastError();
}

template <typename T, typename C = compute_t<T>>
int launch_rec1(const void* a, const void* d, void* out, long long n, int k,
                int left, const void* taps, double scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)(kChunk + k - 1) * sizeof(C);  // under 48 KB
  rec1_level_kernel<T, C><<<num_chunks(n), kThreads, smem, stream>>>(
      (const T*)a, (const T*)d, (T*)out, n, k, left, make_taps1<C>(taps),
      (C)scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. n >= 1 samples, k <= 76 taps, left the window's left halo;
// taps: 2 * 76 of the compute type (float for dtypes 0 and 1, double for 2),
// lo then hi. The caller makes the arrays' device current. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

// x (n,) -> detail (n,), written where the caller points (a band of the
// (B, n) band array), and approx_out (n,).
extern "C" int nddwt_dec1_level(const void* x, void* detail, void* approx_out,
                                int dtype, long long n, int k, int left,
                                const void* taps, double lam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dec1<float>(x, detail, approx_out, n, k, left, taps, lam, s);
  if (dtype == 1)
    return launch_dec1<__nv_bfloat16>(x, detail, approx_out, n, k, left, taps,
                                      lam, s);
  if (dtype == 2)
    return launch_dec1<double>(x, detail, approx_out, n, k, left, taps, lam, s);
  return (int)cudaErrorInvalidValue;
}

// The approximation a (n,) and a detail band d (n,) -> out (n,).
extern "C" int nddwt_rec1_level(const void* a, const void* d, void* out,
                                int dtype, long long n, int k, int left,
                                const void* taps, double scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rec1<float>(a, d, out, n, k, left, taps, scale, s);
  if (dtype == 1)
    return launch_rec1<__nv_bfloat16>(a, d, out, n, k, left, taps, scale, s);
  if (dtype == 2)
    return launch_rec1<double>(a, d, out, n, k, left, taps, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
