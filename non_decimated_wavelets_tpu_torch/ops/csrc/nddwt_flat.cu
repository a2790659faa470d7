// The whole multilevel non-decimated DWT of a small array of any ndim, in
// one launch, hand-written for Hopper.
//
//   nddwt_flat_pair  replaces the TPU kernel _make_flat_pair_kernel
//                    (non_decimated_wavelets_tpu/ops/pallas_flat.py:269),
//                    and with it the resident kernels _make_res_dec_kernel,
//                    _make_res_pair_kernel and _make_res_rec_kernel
//                    (non_decimated_wavelets_tpu/ops/pallas_resident.py:84,
//                    269, 350), which compute its dec, pair and rec modes on
//                    a subset of its shapes;
//   nddwt_flat_iter  replaces the TPU kernel _make_flat_iter_kernel
//                    (non_decimated_wavelets_tpu/ops/pallas_flat.py:495).
//
// Modes. dec: x (batch, *s) -> bands (batch, B, *s). rec: bands -> x. pair:
// dec, soft-threshold the details by lam, rec; both outputs. chain: N
// sweeps x <- W^T shrink_lam_i(W x). fista: x_0 = z_0 = M b, then for each
// i: v = z - step M(M z - b), x+ = W^T shrink_lam_i(W v), z+ = x+ +
// mom_i (x+ - x); the (lam_i, mom_i) schedule is a device array. chain and
// fista return the last x; their bands are scratch. With a batch of 2 (a
// split re/im pair, or a complex array's parts) the shrink couples the two
// components through the complex magnitude (pallas_flat.py:243-264); band
// 0 is never shrunk. The shrink is v max(|v| - lam, 0) / max(|v|, 1e-30).
//
// Types. float and bfloat16 storage compute in float32, double in float64
// (the TPU's flat kernels take no float64). Bands, and in the iterates the
// state x and z, are stored in the storage type between passes, as the TPU
// kernel keeps them (pallas_flat.py:622-628); the approximation and the
// synthesis partial sums stay in the compute type.
//
// Design. On the TPU the whole padded array lives in VMEM as an (8, P/8)
// view and every circular shift is a lane and sublane roll. No CTA of an
// H100 holds that and nothing carries over between CTAs, so the array and
// every working copy live in device memory (at the sizes the wrappers
// admit they stay in the 50 MB L2) and one cooperative launch of a
// persistent grid runs the level and iteration loops, with a grid-wide
// barrier between dependent passes (nddwt_grid.cuh). A pass is a
// grid-stride loop over the flat index; the coordinate along the pass's
// axis comes from its stride, and every tap index wraps mod the extent.
// Per level the passes factor as the TPU kernels' band trees
// (pallas_kernels.py:1257,1281, _tree_reduce/_tree_expand): the analysis
// applies axis a to each of the 2^a partial bands (lo and hi from one read
// of the window), the synthesis applies the adjoint of axis a to the sum of
// the band pairs that differ in bit a; one barrier per pass. Every pass
// writes other arrays than it reads; the approximation and the synthesis
// output ping-pong between two buffers.
//
// What bounds it. Bytes, at the sizes it serves: at 256^2 db4 L3 f32 one
// pair reads x and writes the bands and x (1.5 MB, 0.5 us at 3.35 TB/s),
// against 2 K multiply-adds per band element and axis (about 30 MFLOP,
// 0.5 us at 67 TFLOP/s). Neither is what it spends its time on: every
// pass ends at a grid barrier, 2 L d of them per pair plus one, so at these
// sizes barrier latency and the passes' fill and drain set the time. The
// design's answer is one launch instead of the per-level route's 2 L (and
// the solvers' 2 L + 1 per iteration): the host is out of the loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_common.cuh"
#include "nddwt_grid.cuh"

namespace {

constexpr int kMaxDim = 8;  // transformed axes a launch may have
enum Mode { kDec = 0, kRec = 1, kPair = 2, kChain = 3, kFista = 4 };

template <typename T, typename C>
struct FlatArgs {
  const T* x;      // dec, pair, chain: the input; fista: b. (batch, *s)
  const T* mask;   // fista: the sampling mask (*s), shared by the batch
  T* bands;        // (batch, B, *s): out of dec/pair, in of rec, scratch
  T* out;          // (batch, *s): rec/pair result; chain/fista: the state x
  T* z;            // fista: the momentum state (batch, *s)
  C* work;         // compute-type scratch, flat_work_words() of them
  const C* taps;   // (ndim, 2, kMaxTaps): lo, hi of each axis
  const C* sched;  // (n_iter, 2): lam_i, mom_i (chain, fista)
  int mode, ndim, batch, level, nbands, n_iter, numel;
  int n[kMaxDim], stride[kMaxDim], k[kMaxDim];
  C lam, step, scale;
};

// Partial bands of a level: 2^(d-1) arrays of batch * numel.
__host__ __device__ __forceinline__ long long flat_half(int ndim) {
  return ndim > 1 ? 1LL << (ndim - 1) : 0;
}

// V (the analysis input), A0, A1 (approximation / synthesis output), then
// P0, P1 (partial bands): each batch * numel words, P0/P1 2^(d-1) of them.
long long flat_work_words(int ndim, long long nb_elems) {
  return (3 + 2 * flat_half(ndim)) * nb_elems;
}

template <typename C>
__device__ __forceinline__ C fmax_c(C a, C b) { return a > b ? a : b; }
__device__ __forceinline__ float sqrt_c(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_c(double v) { return sqrt(v); }

// The coordinate of flat index p along axis ax.
template <typename T, typename C>
__device__ __forceinline__ int coord_of(const FlatArgs<T, C>& a, int p, int ax) {
  return (p / a.stride[ax]) % a.n[ax];
}

// lo, hi at p of the analysis along axis ax: sum_j t[j] v[p + (j - L) S],
// L = K/2 - 1, the coordinate wrapping mod n.
template <typename T, typename C>
__device__ __forceinline__ void corr2(const FlatArgs<T, C>& a,
                                      const C (*taps)[2][kMaxTaps],
                                      const C* __restrict__ v, int p, int ax,
                                      C& lo, C& hi) {
  const int n = a.n[ax], S = a.stride[ax], K = a.k[ax];
  const int c0 = coord_of(a, p, ax);
  int c = c0 - (K / 2 - 1);
  int q = p - (K / 2 - 1) * S;
  if (c < 0) {
    c += n;
    q += n * S;
  }
  const C* tl = taps[ax][0];
  const C* th = taps[ax][1];
  lo = 0;
  hi = 0;
  for (int j = 0; j < K; ++j) {
    const C val = v[q];
    lo = mad(tl[j], val, lo);
    hi = mad(th[j], val, hi);
    if (++c == n) {
      c = 0;
      q -= (n - 1) * S;
    } else {
      q += S;
    }
  }
}

// The adjoint of one analysis row at p: sum_j t[j] y[p - (j - L) S].
template <typename Src, typename T, typename C>
__device__ __forceinline__ C corr_adj(const FlatArgs<T, C>& a, const C* t,
                                      const Src* __restrict__ y, int p, int ax) {
  const int n = a.n[ax], S = a.stride[ax], K = a.k[ax];
  const int L = K / 2 - 1;
  int c = coord_of(a, p, ax) + L;
  int q = p + L * S;
  if (c >= n) {
    c -= n;
    q -= n * S;
  }
  C acc = 0;
  for (int j = 0; j < K; ++j) {
    acc = mad(t[j], (C)to_f(y[q]), acc);
    if (c == 0) {
      c = n - 1;
      q += (n - 1) * S;
    } else {
      --c;
      q -= S;
    }
  }
  return acc;
}

template <typename T, typename C>
__device__ __forceinline__ T* band_ptr(const FlatArgs<T, C>& a, T* bands,
                                       int bi, int band) {
  return bands + ((long long)bi * a.nbands + band) * a.numel;
}

// The multilevel analysis of V into a.bands, details shrunk by lam.
template <typename T, typename C>
__device__ void analysis(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps],
                         C lam) {
  const long long nbe = (long long)a.batch * a.numel;
  C* V = a.work;
  C* A[2] = {a.work + nbe, a.work + 2 * nbe};
  C* P[2] = {a.work + 3 * nbe, a.work + (3 + flat_half(a.ndim)) * nbe};
  const int d = a.ndim, nb = 1 << d, numel = a.numel, batch = a.batch;
  for (int lvl = 0; lvl < a.level; ++lvl) {
    const C* approx = lvl == 0 ? V : A[(lvl - 1) & 1];
    C* next = A[lvl & 1];
    const bool final = lvl == a.level - 1;
    const int off = dec_detail_offset(a.nbands, nb, lvl);
    // Axes 0 .. d-2: node r of 2^ax -> children r and r + 2^ax.
    for (int ax = 0; ax + 1 < d; ++ax) {
      const C* in = ax == 0 ? approx : P[(ax - 1) & 1];
      C* out = P[ax & 1];
      const unsigned int nodes = 1u << ax;
      const unsigned int items = nodes * batch * numel;
      for (unsigned int it = first_item(); it < items; it += item_stride()) {
        const int p = it % numel;
        const unsigned int r = it / numel;  // node * batch + bi
        C lo, hi;
        corr2(a, taps, in + (long long)r * numel, p, ax, lo, hi);
        out[(long long)r * numel + p] = lo;
        out[((long long)r + nodes * batch) * numel + p] = hi;
      }
      grid_barrier();
    }
    // The last axis gives the leaves: band 0 (the approximation) and the
    // details, shrunk jointly over the batch.
    const int ax = d - 1;
    const C* in = d == 1 ? approx : P[(d - 2) & 1];
    const unsigned int parents = 1u << ax;
    const unsigned int items = parents * numel;
    for (unsigned int it = first_item(); it < items; it += item_stride()) {
      const int p = it % numel;
      const int node = it / numel;
      C v[2][2];  // [bi][lo/hi]
      for (int bi = 0; bi < batch; ++bi)
        corr2(a, taps, in + ((long long)node * batch + bi) * numel, p, ax,
              v[bi][0], v[bi][1]);
      for (int s = 0; s < 2; ++s) {
        const int b = node + s * parents;
        if (b == 0) {
          for (int bi = 0; bi < batch; ++bi) {
            if (final)
              band_ptr(a, a.bands, bi, 0)[p] = from_f<T>(v[bi][0]);
            else
              next[(long long)bi * numel + p] = v[bi][0];
          }
          continue;
        }
        if (lam > 0) {
          const C m = batch == 2
                          ? sqrt_c(v[0][s] * v[0][s] + v[1][s] * v[1][s])
                          : (v[0][s] < 0 ? -v[0][s] : v[0][s]);
          const C f = fmax_c(m - lam, (C)0) / fmax_c(m, (C)1e-30);
          for (int bi = 0; bi < batch; ++bi) v[bi][s] *= f;
        }
        for (int bi = 0; bi < batch; ++bi)
          band_ptr(a, a.bands, bi, off + b - 1)[p] = from_f<T>(v[bi][s]);
      }
    }
    grid_barrier();
  }
}

// The last synthesis pass's value r at (bi, p), written as the mode says;
// it also leaves the next iterate's analysis input in V.
template <typename T, typename C>
__device__ __forceinline__ void epilogue(const FlatArgs<T, C>& a, int bi,
                                         int p, C r, C mom) {
  const long long idx = (long long)bi * a.numel + p;
  if (a.mode == kFista) {
    const C xo = to_f(a.out[idx]);
    const T zt = from_f<T>(r + mom * (r - xo));
    a.out[idx] = from_f<T>(r);
    a.z[idx] = zt;
    const C zv = to_f(zt);
    const C m = to_f(a.mask[p]);
    a.work[idx] = zv - a.step * (m * (m * zv - (C)to_f(a.x[idx])));
    return;
  }
  const T xt = from_f<T>(r);
  a.out[idx] = xt;
  if (a.mode == kChain) a.work[idx] = to_f(xt);
}

// The multilevel synthesis of `ys` (band-major per batch item, storage
// type) into the epilogue.
template <typename T, typename C>
__device__ void synthesis(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps],
                          const T* ys, C mom) {
  const long long nbe = (long long)a.batch * a.numel;
  C* A[2] = {a.work + nbe, a.work + 2 * nbe};
  C* P[2] = {a.work + 3 * nbe, a.work + (3 + flat_half(a.ndim)) * nbe};
  const int d = a.ndim, nb = 1 << d, numel = a.numel, batch = a.batch;
  for (int lvl = 0; lvl < a.level; ++lvl) {
    const C* acc_in = lvl == 0 ? nullptr : A[(lvl - 1) & 1];
    C* acc_out = A[lvl & 1];
    const bool last = lvl == a.level - 1;
    for (int ax = 0; ax < d; ++ax) {
      // Group g sums the adjoints of its inputs 2g (lo) and 2g + 1 (hi).
      const unsigned int groups = 1u << (d - 1 - ax);
      const unsigned int items = groups * batch * numel;
      const C* in = ax == 0 ? nullptr : P[(ax - 1) & 1];
      C* out = P[ax & 1];
      for (unsigned int it = first_item(); it < items; it += item_stride()) {
        const int p = it % numel;
        const unsigned int r = it / numel;  // g * batch + bi
        const int g = r / batch, bi = r % batch;
        C sum = 0;
        for (int s = 0; s < 2; ++s) {
          const C* t = taps[ax][s];
          const int b = 2 * g + s;
          if (ax > 0) {
            sum += corr_adj(a, t, in + ((long long)b * batch + bi) * numel, p, ax);
          } else if (b == 0 && lvl > 0) {
            sum += corr_adj(a, t, acc_in + (long long)bi * numel, p, ax);
          } else {
            const T* src = ys + ((long long)bi * a.nbands + rec_band_index(nb, lvl, b)) *
                                    (long long)numel;
            sum += corr_adj(a, t, src, p, ax);
          }
        }
        if (ax + 1 < d)
          out[(long long)r * numel + p] = sum;
        else if (last)
          epilogue(a, bi, p, sum * a.scale, mom);
        else
          acc_out[(long long)bi * numel + p] = sum * a.scale;
      }
      if (!(last && ax + 1 == d)) grid_barrier();
    }
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const __grid_constant__ FlatArgs<T, C> a) {
  __shared__ C taps[kMaxDim][2][kMaxTaps];
  for (int i = threadIdx.x; i < a.ndim * 2 * kMaxTaps; i += blockDim.x)
    (&taps[0][0][0])[i] = a.taps[i];
  __syncthreads();
  const unsigned int nbe = a.batch * a.numel;
  C* V = a.work;
  if (a.mode == kRec) {
    synthesis(a, taps, a.bands, (C)0);
    return;
  }
  // The analysis input V: x (dec, pair, chain) or z_0 - step M(M z_0 - b)
  // with x_0 = z_0 = M b (fista).
  for (unsigned int i = first_item(); i < nbe; i += item_stride()) {
    if (a.mode == kFista) {
      const C m = to_f(a.mask[i % a.numel]);
      const C b = to_f(a.x[i]);
      const T x0 = from_f<T>(m * b);
      a.out[i] = x0;
      a.z[i] = x0;
      const C zv = to_f(x0);
      V[i] = zv - a.step * (m * (m * zv - b));
    } else {
      V[i] = to_f(a.x[i]);
    }
  }
  grid_barrier();
  if (a.mode == kDec || a.mode == kPair) {
    analysis(a, taps, a.lam);
    if (a.mode == kPair) synthesis(a, taps, a.bands, (C)0);
    return;
  }
  for (int i = 0; i < a.n_iter; ++i) {
    analysis(a, taps, a.sched[2 * i]);
    synthesis(a, taps, a.bands, a.sched[2 * i + 1]);
    if (i + 1 < a.n_iter) grid_barrier();
  }
}

template <typename T, typename C = compute_t<T>>
int launch_flat(int mode, const void* x, const void* mask, void* bands,
                void* out, void* z, void* work, const void* taps,
                const void* sched, int ndim, int batch, int level, int n_iter,
                const int* n, const int* k, double lam, double step,
                double scale, cudaStream_t stream) {
  if (ndim < 1 || ndim > kMaxDim || (batch != 1 && batch != 2) || level < 1)
    return (int)cudaErrorInvalidValue;
  FlatArgs<T, C> a{};
  a.x = (const T*)x;
  a.mask = (const T*)mask;
  a.bands = (T*)bands;
  a.out = (T*)out;
  a.z = (T*)z;
  a.work = (C*)work;
  a.taps = (const C*)taps;
  a.sched = (const C*)sched;
  a.mode = mode;
  a.ndim = ndim;
  a.batch = batch;
  a.level = level;
  a.nbands = (1 << ndim) + ((1 << ndim) - 1) * (level - 1);
  a.n_iter = n_iter;
  long long numel = 1;
  for (int ax = ndim - 1; ax >= 0; --ax) {
    if (n[ax] < 1 || k[ax] < 2 || k[ax] > kMaxTaps || k[ax] > n[ax])
      return (int)cudaErrorInvalidValue;
    a.n[ax] = n[ax];
    a.k[ax] = k[ax];
    a.stride[ax] = (int)numel;
    numel *= n[ax];
  }
  const long long max_items = flat_half(ndim) > 0 ? flat_half(ndim) * batch * numel
                                                  : batch * numel;
  if (max_items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.numel = (int)numel;
  a.lam = (C)lam;
  a.step = (C)step;
  a.scale = (C)scale;
  return launch_cooperative(flat_kernel<T, C>, a, max_items, kThreads, stream);
}

template <typename T>
int dispatch(int mode, const void* x, const void* mask, void* bands, void* out,
             void* z, void* work, const void* taps, const void* sched, int ndim,
             int batch, int level, int n_iter, const int* n, const int* k,
             double lam, double step, double scale, void* stream) {
  return launch_flat<T>(mode, x, mask, bands, out, z, work, taps, sched, ndim,
                        batch, level, n_iter, n, k, lam, step, scale,
                        (cudaStream_t)stream);
}

int dispatch_dtype(int dtype, int mode, const void* x, const void* mask,
                   void* bands, void* out, void* z, void* work,
                   const void* taps, const void* sched, int ndim, int batch,
                   int level, int n_iter, const int* n, const int* k,
                   double lam, double step, double scale, void* stream) {
  if (dtype == 0)
    return dispatch<float>(mode, x, mask, bands, out, z, work, taps, sched,
                           ndim, batch, level, n_iter, n, k, lam, step, scale,
                           stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(mode, x, mask, bands, out, z, work, taps,
                                   sched, ndim, batch, level, n_iter, n, k,
                                   lam, step, scale, stream);
  if (dtype == 2)
    return dispatch<double>(mode, x, mask, bands, out, z, work, taps, sched,
                            ndim, batch, level, n_iter, n, k, lam, step, scale,
                            stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. ndim <= kMaxDim transformed axes of extents n (slowest
// first) and tap counts k (2 <= k <= min(76, n)); batch 1, or 2 for a
// split re/im pair; taps: ndim * 2 * 76 of the compute type (float for
// dtypes 0 and 1, double for 2) in device memory. work: nddwt_flat_work_words
// words of the compute type. The caller allocates every array on the
// device and makes it current. Returns the cudaError_t of the cooperative
// launch (0 on success), which is asynchronous on `stream`.
extern "C" int nddwt_flat_max_dim() { return kMaxDim; }
extern "C" int nddwt_flat_max_taps() { return kMaxTaps; }
extern "C" long long nddwt_flat_work_words(int ndim, long long batch_numel) {
  return flat_work_words(ndim, batch_numel);
}

// mode 0 (dec): x -> bands. 1 (rec): bands -> out. 2 (pair): x -> bands
// (details shrunk by lam) -> out. scale: the synthesis's per-level factor.
extern "C" int nddwt_flat_pair(int mode, const void* x, void* bands, void* out,
                               void* work, const void* taps, int dtype,
                               int ndim, int batch, int level, const int* n,
                               const int* k, double lam, double scale,
                               void* stream) {
  if (mode < kDec || mode > kPair) return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, mode, x, nullptr, bands, out, nullptr, work,
                        taps, nullptr, ndim, batch, level, 0, n, k, lam, 0.0,
                        scale, stream);
}

// mode 3 (chain): x -> out after n_iter sweeps. mode 4 (fista): b = x and
// mask (*s) -> out, with z the momentum state. bands: (batch, B, *s)
// scratch; sched: n_iter (lam, mom) rows of the compute type on the
// device.
extern "C" int nddwt_flat_iter(int mode, const void* x, const void* mask,
                               void* bands, void* out, void* z, void* work,
                               const void* taps, const void* sched, int dtype,
                               int ndim, int batch, int level, int n_iter,
                               const int* n, const int* k, double step,
                               double scale, void* stream) {
  if ((mode != kChain && mode != kFista) || n_iter < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, mode, x, mask, bands, out, z, work, taps, sched,
                        ndim, batch, level, n_iter, n, k, 0.0, step, scale,
                        stream);
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
