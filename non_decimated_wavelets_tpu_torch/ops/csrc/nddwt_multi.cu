// The whole multilevel non-decimated DWT of a batch of 2D or 3D arrays, one
// launch per direction, hand-written for Hopper.
//
//   nddwt_dec_multi  replaces the TPU kernel _make_dec_multi_kernel /
//                    _fused_dec_multi
//                    (non_decimated_wavelets_tpu/ops/pallas_kernels.py:1037,
//                    1142)
//   nddwt_rec_multi  replaces the TPU kernel _make_rec_multi_kernel /
//                    _fused_rec_multi
//                    (non_decimated_wavelets_tpu/ops/pallas_kernels.py:1526,
//                    1632)
//
// Both take float and bfloat16 arrays, computing in float32 with float32
// taps, and double arrays, computing in float64 (the TPU's multilevel
// kernels take no float64).
//
// Contract. Analysis: x (N, *s) -> bands (N, B, *s), B = 2^d + (2^d -
// 1)(L - 1), band-first per item in the layout of the per-level route
// (nddwt_grid.cuh): level l (0 = finest) reads x (l = 0) or ping slot
// (l - 1) % 2, writes its 2^d - 1 details at dec_detail_offset(B, 2^d, l),
// soft-thresholded by lam > 0 (pallas_kernels.py:509-515), and its
// approximation to ping slot l % 2, or to band 0 at the last level.
// Synthesis: bands (N, B, *s) -> out (N, *s): level l (0 = deepest) reads
// band 0 from the bands (l = 0) or ping slot (l - 1) % 2 and the details at
// rec_band_index(2^d, l, b), multiplies by scale (1, or 1/2^d without
// preserve_l2) and writes ping slot l % 2, or out at the last level. The
// ping slots hold the approximations in the storage type, as the TPU's
// ping_ref (pallas_kernels.py:1176-1177) and the per-level route do, so a
// bfloat16 cascade rounds where the per-level chain rounds. A level never
// reads the slot it writes; L = 2 needs one slot, L >= 3 two.
//
// Design. On the TPU the grid is (level, tiles), run in order on one core,
// so level l + 1's DMA reads what level l wrote. Hopper CTAs run in no
// order, so this is one cooperative launch of a persistent grid
// (nddwt_grid.cuh), two CTAs an SM, with a grid-wide barrier between levels.
// Each level's work is the per-level kernels' (nddwt_dec_level,
// nddwt_rec_level): the streamed bodies of nddwt_stream.cuh, the same view,
// halos, taps and plan (C, T1, T2). A unit is one CTA tile of the per-level
// launch of one item, (item, a chunk of C outputs along slot 0, a (T1, T2)
// plane tile); the chunk is sized so that the whole batch's units fill one
// wave (ops/multi.py), and the CTAs claim each level's units from a
// per-level counter (claiming was faster than the fixed order c, c + grid,
// ... at every chip_ab_multi.py shape, though the units fill one wave:
// PERF.md). A 3D item is the view (n0, n1, n2), a 2D one (n0, 1, n1). A 2D
// batch whose rows are narrower than a plane tile is the view (n0, N, n1):
// the items fill the pass-through slot 1, so that a plane tile covers T1
// items' rows instead of masking all but one row of 1024 lanes, and each
// array steps from item to item by its own stride (Fold). Level
// l + 1 reads what other CTAs wrote at level l through cp.async and plain
// loads (never the read-only path), ordered by the grid barrier's fences.
// The synthesis's band table lives in shared memory. Every offset is 64-bit:
// 32 complex items of 22 bands at 4M voxels pass 2^31. A launch the device
// refuses returns its error and the wrapper raises.
//
// What bounds it: the per-level kernels' work, L levels of it, in one
// launch: an analysis level reads the approximation once and writes 2^d
// arrays (9 arrays moved in 3D), a synthesis level the reverse, so bytes
// bound it (0.0138 ms for the multi-coil slice's 16 x 256^2 db4 L3 f32
// components), and the streamed bodies' copies and passes set the time. On
// an H100 80GB HBM3 at 700 W (chip_ab_multi.py, queued, PERF.md) that
// batch takes 0.0762 ms (analysis) and 0.1676 ms (synthesis), 18 % and 8 %
// of the bound, against 0.8315 and 2.4638 ms for the per-level chain's 48
// launches; builds that skip the passes or the copies take 0.0315 and
// 0.0435 ms (analysis), 0.1073 and 0.0894 ms (synthesis). One 128^3 item
// takes 0.2207 and 0.7738 ms (per-level 0.2427, 0.7818); one 2048^2 item's
// analysis 0.1651 ms against 0.1288: at the two-CTA register cap the
// multilevel loop's pointers push the 2D db4 analysis into spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_grid.cuh"
#include "nddwt_stream.cuh"

namespace {

// The launch's arguments. The unit counts and strides are worked out on the
// host, so that the kernel reads them from the parameter space where it
// needs them and keeps no register for them across a unit.
template <typename T, typename C>
struct MultiArgs {
  const T* src;  // analysis: x (N, *s); synthesis: bands (N, B, *s)
  T* dst;        // analysis: bands (N, B, *s); synthesis: out (N, *s)
  T* ping;       // (slots, N, *s): the approximations between levels
  unsigned long long* next;  // (level,) zeros: each level's next unit
  LevelT<C> g;   // the streamed view, t = (C, T1, T2)
  long long vox;   // elements of one item
  long long slot;  // elements of one ping slot, items * vox
  long long bvox;  // elements of one item's bands, nbands * vox
  long long units;  // a level's units: per_item, times items unless folded
  int t2n, t1n, per_item;  // plane tiles along slots 2 and 1; units an item
  int items, level, nb, nbands, stages, gw;
  C coef;  // analysis: lam; synthesis: scale
};

// Unit u of a level: its item (0 where the batch is folded into slot 1) and
// origin (o2, o1, p0); chunks along slot 0 times plane tiles, slot 2
// fastest.
template <typename T, typename C>
__device__ __forceinline__ long long unit_origin(const MultiArgs<T, C>& a, long long u,
                                                 int& o2, int& o1, int& p0) {
  const long long item = u / a.per_item;
  int r = (int)(u - item * a.per_item);
  o2 = r % a.t2n * a.g.t[2];
  r /= a.t2n;
  o1 = r % a.t1n * a.g.t[1];
  p0 = r / a.t1n * a.g.t[0];
  return item;
}

// Level l's next unit for this CTA (a value >= the level's units when there
// is none), shared by the CTA's threads. The first barrier also waits for
// the previous unit's shared memory to be consumed.
__device__ __forceinline__ long long claim(unsigned long long* next, int l,
                                           long long* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = (long long)atomicAdd(next + l, 1ULL);
  __syncthreads();
  return *slot;
}

template <typename T, int KT, int G, bool FOLD, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    dec_multi_kernel(const __grid_constant__ MultiArgs<T, C> a) {
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ long long claimed;
  copy_taps(taps, a.g);
  unsigned char* const smem = reinterpret_cast<unsigned char*>(shared_words<C>());
  for (int l = 0; l < a.level; ++l) {
    if (l > 0) grid_barrier();  // level l - 1's approximation is written
    const bool final = l == a.level - 1;
    const T* in = l == 0 ? a.src : a.ping + (l - 1) % 2 * a.slot;
    T* approx = final ? a.dst : a.ping + l % 2 * a.slot;
    const long long astep = final ? a.bvox : a.vox;  // the approximation's item stride
    const Fold f{a.vox, 0, a.bvox, astep};
    const long long off = dec_detail_offset(a.nbands, a.nb, l);
    for (long long u; (u = claim(a.next, l, &claimed)) < a.units;) {
      int o2, o1, p0;
      const long long item = unit_origin(a, u, o2, o1, p0);
      stream_ana<T, KT, G, FOLD>(in + item * a.vox, a.dst + item * a.bvox,
                                 approx + item * astep, a.g, 1, a.gw, off, a.coef,
                                 a.stages, taps, smem, o2, o1, p0, f);
    }
  }
}

template <typename T, int KT, bool FOLD, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    rec_multi_kernel(const __grid_constant__ MultiArgs<T, C> a) {
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ StreamSources src;  // this level's band table
  __shared__ long long claimed;
  copy_taps(taps, a.g);
  unsigned char* const smem = reinterpret_cast<unsigned char*>(shared_words<C>());
  for (int l = 0; l < a.level; ++l) {
    if (l > 0) grid_barrier();  // level l - 1's output is written
    const bool final = l == a.level - 1;
    // Written once the CTA has left the previous level (the grid barrier),
    // read by this level's units after claim()'s barriers.
    if (threadIdx.x < kStreamBands) {
      const int b = threadIdx.x;
      src.idx[b] = b >= a.nb || (l > 0 && b == 0) ? -1 : rec_band_index(a.nb, l, b);
    }
    const T* approx = l == 0 ? a.src : a.ping + (l - 1) % 2 * a.slot;
    const long long astep = l == 0 ? a.bvox : a.vox;  // approx's item stride
    T* out = final ? a.dst : a.ping + l % 2 * a.slot;
    const Fold f{a.bvox, astep, a.vox, 0};
    for (long long u; (u = claim(a.next, l, &claimed)) < a.units;) {
      int o2, o1, p0;
      const long long item = unit_origin(a, u, o2, o1, p0);
      stream_syn<T, KT, FOLD>(a.src + item * a.bvox, approx + item * astep,
                              out + item * a.vox, a.g, src, 1, a.coef, a.stages, taps,
                              smem, o2, o1, p0, f);
    }
  }
}

template <typename T, int G, bool FOLD, typename C = compute_t<T>>
auto dec_multi_for(int kt) {
  switch (kt) {
    case 2: return dec_multi_kernel<T, 2, G, FOLD, C>;
    case 4: return dec_multi_kernel<T, 4, G, FOLD, C>;
    case 6: return dec_multi_kernel<T, 6, G, FOLD, C>;
    case 8: return dec_multi_kernel<T, 8, G, FOLD, C>;
    default: return dec_multi_kernel<T, 0, G, FOLD, C>;
  }
}

template <typename T, bool FOLD, typename C = compute_t<T>>
auto rec_multi_for(int kt) {
  switch (kt) {
    case 2: return rec_multi_kernel<T, 2, FOLD, C>;
    case 4: return rec_multi_kernel<T, 4, FOLD, C>;
    case 6: return rec_multi_kernel<T, 6, FOLD, C>;
    case 8: return rec_multi_kernel<T, 8, FOLD, C>;
    default: return rec_multi_kernel<T, 0, FOLD, C>;
  }
}

template <typename T, typename C = compute_t<T>>
int launch_multi(bool rec, const void* src, void* dst, void* ping, void* next,
                 int ndim, int items, int level, const int* n, const int* k,
                 const int* t, const int* left, const int* bit, const void* taps,
                 int gw, double coef, cudaStream_t stream) {
  const bool fold = ndim == 2 && n[1] > 1;  // a 2D batch in slot 1
  if ((ndim != 2 && ndim != 3) || items < 1 || level < 1 || n[0] < 1 || n[1] < 1 ||
      n[2] < 1 || (ndim == 2 && (k[1] != 1 || (fold && n[1] != items))))
    return (int)cudaErrorInvalidValue;
  MultiArgs<T, C> a;
  a.src = (const T*)src;
  a.dst = (T*)dst;
  a.ping = (T*)ping;
  a.next = (unsigned long long*)next;
  a.g = make_level<C>(n, k, t, left, bit, taps);
  a.vox = ndim == 2 ? (long long)n[0] * n[2] : (long long)n[0] * n[1] * n[2];
  a.items = items;
  a.level = level;
  a.nb = 1 << ndim;
  a.nbands = a.nb + (a.nb - 1) * (level - 1);
  a.slot = (long long)items * a.vox;
  a.bvox = (long long)a.nbands * a.vox;
  a.t2n = (n[2] + t[2] - 1) / t[2];
  a.t1n = (n[1] + t[1] - 1) / t[1];
  a.per_item = a.t2n * a.t1n * ((n[0] + t[0] - 1) / t[0]);
  a.units = fold ? a.per_item : (long long)a.per_item * items;
  a.coef = (C)coef;
  // The plan the streamed bodies take (launch_stream, launch_stream_ana),
  // and windows that wrap at most once.
  const int kt = stream_unrolled(a.g.k);
  const int G = ndim == 2 ? 2 : 4;
  const int per_thread = rec         ? (kt > 0 ? kStreamItems : 1)
                         : ndim == 2 ? ana_items_for<C, 2>(kt)
                                     : ana_items_for<C, 4>(kt);
  const int t2 = t[2];
  if (t[0] < 1 || t[1] < 1 || t2 < 1 || (t2 & (t2 - 1)) || k[0] < 2 ||
      t[1] * t2 != kThreads * per_thread)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < 3; ++s)
    if (k[s] > n[s]) return (int)cudaErrorInvalidValue;
  if (!rec && (gw < 1 || gw > G || G % gw || (kt > 0 && gw != G)))
    return (int)cudaErrorInvalidValue;
  a.gw = rec ? 1 : gw;
  a.stages = rec ? stream_stages<T>(a.g, kt == 0) : stream_stages<T>(a.g, kt == 0, a.gw);
  const size_t smem = stream_layout<T>(a.g, kt == 0, a.stages, a.gw).total;
  if (smem > kStreamSmemBudget) return (int)cudaErrorInvalidValue;
  if (rec) {
    auto kernel = fold ? rec_multi_for<T, true>(kt) : rec_multi_for<T, false>(kt);
    return launch_cooperative(kernel, a, a.units, kThreads, stream, smem, 1);
  }
  auto kernel = fold ? dec_multi_for<T, 2, true>(kt)
                     : ndim == 2 ? dec_multi_for<T, 2, false>(kt)
                                 : dec_multi_for<T, 4, false>(kt);
  return launch_cooperative(kernel, a, a.units, kThreads, stream, smem, 1);
}

int dispatch(int dtype, bool rec, const void* src, void* dst, void* ping, void* next,
             int ndim, int items, int level, const int* n, const int* k, const int* t,
             const int* left, const int* bit, const void* taps, int gw, double coef,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_multi<float>(rec, src, dst, ping, next, ndim, items, level, n, k, t,
                               left, bit, taps, gw, coef, s);
  if (dtype == 1)
    return launch_multi<__nv_bfloat16>(rec, src, dst, ping, next, ndim, items, level, n,
                                       k, t, left, bit, taps, gw, coef, s);
  if (dtype == 2)
    return launch_multi<double>(rec, src, dst, ping, next, ndim, items, level, n, k, t,
                                left, bit, taps, gw, coef, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. ndim 2 or 3 spatial axes; n, k, t, left, bit: 3 ints each,
// the streamed view of the per-level kernels (slot 0 slowest) with the
// batch's plan t = (C, T1, T2): a 3D item's (n0, n1, n2), a 2D item's
// (n0, 1, n1), or a 2D batch's (n0, N, n1), its items in the pass-through
// slot 1; the analysis's or the synthesis's (reversed) taps: 3 * 2 * 76 of
// the compute type (float for dtypes 0 and 1, double for 2), in host
// memory. items: the batch N >= 1; level L >= 1; gw: the analysis's
// in-plane bands a walk (as nddwt_dec_level takes it). ping: min(L - 1, 2)
// * N arrays of the spatial shape (unused at L = 1); next: L unsigned
// 64-bit zeros, the per-level unit counters (left nonzero). The caller
// allocates every array on the device and makes it current. Returns the cudaError_t of the cooperative launch
// (0 on success), which is asynchronous on `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

// x (N, *s) -> bands (N, B, *s); details shrunk by lam > 0.
extern "C" int nddwt_dec_multi(const void* x, void* bands, void* ping, void* next,
                               int dtype, int ndim, int items, int level, const int* n,
                               const int* k, const int* t, const int* left,
                               const int* bit, const void* taps, int gw, double lam,
                               void* stream) {
  return dispatch(dtype, false, x, bands, ping, next, ndim, items, level, n, k, t, left,
                  bit, taps, gw, lam, stream);
}

// bands (N, B, *s) -> out (N, *s); scale: the per-level factor.
extern "C" int nddwt_rec_multi(const void* bands, void* out, void* ping, void* next,
                               int dtype, int ndim, int items, int level, const int* n,
                               const int* k, const int* t, const int* left,
                               const int* bit, const void* taps, double scale,
                               void* stream) {
  return dispatch(dtype, true, bands, out, ping, next, ndim, items, level, n, k, t, left,
                  bit, taps, 1, scale, stream);
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
