// The FISTA solvers' elementwise passes, hand-written for Hopper.
//
//   nddwt_mag_shrink_pair  replaces the TPU kernel pallas_elemwise.mag_shrink_pair
//                          (non_decimated_wavelets_tpu/ops/pallas_elemwise.py:57)
//   nddwt_fista_step       replaces the TPU kernel pallas_elemwise.fista_step
//                          (non_decimated_wavelets_tpu/ops/pallas_elemwise.py:108)
//
// Both read float or bfloat16 storage and compute in float32, as the TPU
// kernels do (_up), or double storage in float64 (a float64 solver; the TPU
// has no such kernel). Unlike them, they take any element count: the TPU
// versions view the arrays as (R, 1024) rows and serve only multiples of
// 1024.
//
// What bounds them: a handful of flops per element against 8 to 20 bytes
// moved, far below the card's 20 flops per byte, so device-memory bytes. At
// 256^3 f32 the shrink moves a (2, 22, 256^3) pair in and out (5.9 GB,
// 1.76 ms at 3.35 TB/s) and the step 4 arrays in and 1 out (0.34 GB,
// 0.10 ms); float64 twice that. The design does what a bytes-bound pass can: each input element
// is read once and each output written once, in one pass (the step reads
// the mask once per re/im pair), with 16-byte (float), 8-byte (bfloat16) or
// 2 x 16-byte (double) vector accesses on consecutive addresses when every pointer and the count
// allow it, element accesses otherwise. A grid-stride loop over at most 8
// CTAs of 256 threads per SM keeps one wave resident.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 8 x 256 threads fill an SM's 2048

// The compute type of a storage type: float for float and bfloat16, double
// for double.
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

// V consecutive elements of T to and from compute_t<T> registers.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = p[0];
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16(v[0]);  // round to nearest even, as torch casts
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned int*>(&a);
    q.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

template <>
struct Vec<double, 1> {
  static __device__ __forceinline__ void load(const double* p, double* v) {
    v[0] = p[0];
  }
  static __device__ __forceinline__ void store(double* p, const double* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<double, 4> {
  static __device__ __forceinline__ void load(const double* p, double* v) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* v) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(re * re + im * im);
}
__device__ __forceinline__ double magnitude(double re, double im) {
  return sqrt(re * re + im * im);
}
__device__ __forceinline__ float shrink_factor(float mag, float lam) {
  return fmaxf(mag - lam, 0.f) / fmaxf(mag, 1e-30f);
}
__device__ __forceinline__ double shrink_factor(double mag, double lam) {
  return fmax(mag - lam, 0.0) / fmax(mag, 1e-30);
}

// y and out hold a split re/im pair: component 0 in [0, n), component 1 in
// [n, 2n), each a band-first (B, *s) array whose first n0 elements are band
// 0. Band 0 passes through; every other element pair is scaled by
// max(|y| - lam, 0) / max(|y|, 1e-30), |y| the joint re/im magnitude.
template <typename T, int V, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    mag_shrink_pair_kernel(const T* __restrict__ y, T* __restrict__ out,
                           long long n, long long n0, C lam) {
  const long long groups = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * V;
    C re[V], im[V];
    Vec<T, V>::load(y + i, re);
    Vec<T, V>::load(y + n + i, im);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (i + k < n0) continue;
      const C fac = shrink_factor(magnitude(re[k], im[k]), lam);
      re[k] *= fac;
      im[k] *= fac;
    }
    Vec<T, V>::store(out + i, re);
    Vec<T, V>::store(out + n + i, im);
  }
}

// v = z - step * m * (m * z - b) with z = x_new + mom * (x_new - x_prev).
// x_new, x_prev, b and v hold `reps` arrays of n elements one after the
// other (reps = 2 for a split re/im pair); the mask holds n and is read
// once for all of them.
template <typename T, int V, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    fista_step_kernel(const T* __restrict__ xn, const T* __restrict__ xp,
                      const T* __restrict__ m, const T* __restrict__ b,
                      T* __restrict__ v, long long n, int reps, C mom,
                      C step) {
  const long long groups = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * V;
    C mk[V];
    Vec<T, V>::load(m + i, mk);
    for (int r = 0; r < reps; ++r) {
      const long long o = r * n + i;
      C a[V], p[V], c[V];
      Vec<T, V>::load(xn + o, a);
      Vec<T, V>::load(xp + o, p);
      Vec<T, V>::load(b + o, c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const C z = a[k] + mom * (a[k] - p[k]);
        a[k] = z - step * (mk[k] * (mk[k] * z - c[k]));
      }
      Vec<T, V>::store(v + o, a);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Vector width 4 when every pointer is aligned to 4 elements and n, the
// offset of the second array of a pair, is a multiple of 4.
template <typename T>
bool vec4(long long n, const void* const* ptrs, int count) {
  if (n % 4) return false;
  for (int i = 0; i < count; ++i)
    if (!aligned(ptrs[i], 4 * sizeof(T))) return false;
  return true;
}

int grid_for(long long groups, unsigned int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long need = (groups + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  *blocks = (unsigned int)(need < cap ? need : cap);
  return 0;
}

template <typename T, typename C = compute_t<T>>
int launch_shrink(const void* y, void* out, long long n, long long n0,
                  double lam, cudaStream_t stream) {
  const void* ptrs[2] = {y, out};
  const bool v4 = vec4<T>(n, ptrs, 2);
  unsigned int blocks = 0;
  const int e = grid_for(v4 ? n / 4 : n, &blocks);
  if (e) return e;
  if (v4)
    mag_shrink_pair_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (T*)out, n, n0, (C)lam);
  else
    mag_shrink_pair_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        (const T*)y, (T*)out, n, n0, (C)lam);
  return (int)cudaGetLastError();
}

template <typename T, typename C = compute_t<T>>
int launch_step(const void* xn, const void* xp, const void* m, const void* b,
                void* v, long long n, int reps, double mom, double step,
                cudaStream_t stream) {
  const void* ptrs[5] = {xn, xp, m, b, v};
  const bool v4 = vec4<T>(n, ptrs, 5);
  unsigned int blocks = 0;
  const int e = grid_for(v4 ? n / 4 : n, &blocks);
  if (e) return e;
  if (v4)
    fista_step_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        (const T*)xn, (const T*)xp, (const T*)m, (const T*)b, (T*)v, n, reps,
        (C)mom, (C)step);
  else
    fista_step_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        (const T*)xn, (const T*)xp, (const T*)m, (const T*)b, (T*)v, n, reps,
        (C)mom, (C)step);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64; the scalars are rounded to the compute type. The
// caller makes the arrays' device current and passes n >= 1. Each returns
// the cudaError_t of the launch (0 on success); the launch is asynchronous
// on `stream`.

// y, out: (2, B, *s) contiguous; n = B * prod(s) elements per component,
// n0 = prod(s) of them in band 0.
extern "C" int nddwt_mag_shrink_pair(const void* y, void* out, int dtype,
                                     long long n, long long n0, double lam,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_shrink<float>(y, out, n, n0, lam, s);
  if (dtype == 1) return launch_shrink<__nv_bfloat16>(y, out, n, n0, lam, s);
  if (dtype == 2) return launch_shrink<double>(y, out, n, n0, lam, s);
  return (int)cudaErrorInvalidValue;
}

// x_new, x_prev, b, v: reps * n elements each, contiguous; mask: n.
extern "C" int nddwt_fista_step(const void* x_new, const void* x_prev,
                                const void* mask, const void* b, void* v,
                                int dtype, long long n, int reps, double mom,
                                double step, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_step<float>(x_new, x_prev, mask, b, v, n, reps, mom, step, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(x_new, x_prev, mask, b, v, n, reps, mom,
                                      step, s);
  if (dtype == 2)
    return launch_step<double>(x_new, x_prev, mask, b, v, n, reps, mom, step, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
