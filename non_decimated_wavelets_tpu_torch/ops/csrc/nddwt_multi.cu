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
// kernels take no float64). A 2D array runs as (1, n0, n1).
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
// (nddwt_grid.cuh): for each level the CTAs claim (batch item, tile) pairs
// from a per-level counter, each running the tile body on it
// (nddwt_tile.cuh, the CTA's shared memory holding one halo'd tile),
// and a grid-wide barrier separates the levels. Claiming keeps a CTA that
// finishes early busy, as the hardware does for the per-level kernels'
// one-tile CTAs: with a fixed grid-stride share per CTA instead, both
// kernels were 4-18 % slower at db4 L3 f32 single arrays on an H100 80GB
// HBM3 at 700 W (chip_ab_multi.py, PERF.md). The synthesis's band table
// lives in shared memory, not in a local array. Loads go through L2 only
// (ld.global.cg): the previous level's writes by other CTAs are not
// coherent with L1 or the read-only cache. Every offset is 64-bit: 32
// complex items of 22 bands at 4M voxels pass 2^31. The grid is sized from
// the occupancy of the tile's shared memory (up to the wrappers' 100 KB
// budget); a launch the device refuses returns its error and the wrapper
// raises.
//
// What bounds it: the per-level kernels' work, L levels of it, in one
// launch: an analysis level reads the approximation once and writes 2^d
// arrays (9 arrays moved in 3D), a synthesis level the reverse, so bytes
// bound it and, as in the per-level kernels, the K-tap passes over shared
// memory are the next limit. Per tile it runs within a few percent of them
// (PERF.md); what it saves is the per-level route's launch per level and
// item, for a batch or a re/im pair of items of at most MULTI_MAX_NUMEL
// voxels, and the card's idle time between small items' levels. TMA and
// wgmma are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_grid.cuh"
#include "nddwt_tile.cuh"

namespace {

template <typename T, typename C>
struct MultiArgs {
  const T* src;  // analysis: x (N, *s); synthesis: bands (N, B, *s)
  T* dst;        // analysis: bands (N, B, *s); synthesis: out (N, *s)
  T* ping;       // (slots, N, *s): the approximations between levels
  unsigned long long* next;  // (level,) zeros: each level's next pair
  LevelT<C> g;
  long long vox;
  int items, level, nb, nbands;
  C coef;  // analysis: lam; synthesis: scale
};

// The next (item, tile) pair of level l for this CTA, or a value >= the
// level's work when there is none; shared by the CTA's threads. The first
// __syncthreads() also waits for the previous tile's shared memory to be
// consumed.
__device__ __forceinline__ long long claim(unsigned long long* next, int l,
                                           long long* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = (long long)atomicAdd(next + l, 1ULL);
  __syncthreads();
  return *slot;
}

// One slot's item: ping + (slot * N + item) * vox.
template <typename T, typename C>
__device__ __forceinline__ T* slot_item(const MultiArgs<T, C>& a, int slot,
                                        long long item) {
  return a.ping + ((long long)slot * a.items + item) * a.vox;
}

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    dec_multi_kernel(const __grid_constant__ MultiArgs<T, C> a) {
  C* smem = shared_words<C>();
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ long long slot;
  copy_taps(taps, a.g);
  const long long tiles = num_tiles(a.g);
  const long long work = tiles * a.items;
  for (int l = 0; l < a.level; ++l) {
    if (l > 0) grid_barrier();  // level l - 1's approximation is written
    const bool final = l == a.level - 1;
    const long long off = dec_detail_offset(a.nbands, a.nb, l);
    for (long long w; (w = claim(a.next, l, &slot)) < work;) {
      const long long item = w / tiles;
      const unsigned int tile = (unsigned int)(w - item * tiles);
      const T* in =
          l == 0 ? a.src + item * a.vox : slot_item(a, (l - 1) % 2, item);
      T* bands = a.dst + item * a.nbands * a.vox;
      T* approx = final ? bands : slot_item(a, l % 2, item);
      dec_tile(in, bands, approx, a.g, taps, smem, off, a.coef, tile);
    }
  }
}

template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    rec_multi_kernel(const __grid_constant__ MultiArgs<T, C> a) {
  C* smem = shared_words<C>();
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ long long slot;
  __shared__ Sources src;  // this level's band table, read by claim()'s barrier
  copy_taps(taps, a.g);
  const long long tiles = num_tiles(a.g);
  const long long work = tiles * a.items;
  for (int l = 0; l < a.level; ++l) {
    if (l > 0) grid_barrier();  // level l - 1's output is written
    const bool final = l == a.level - 1;
    if (threadIdx.x < 8) {
      const int b = threadIdx.x;
      src.idx[b] =
          b >= a.nb || (l > 0 && b == 0) ? -1 : rec_band_index(a.nb, l, b);
    }
    for (long long w; (w = claim(a.next, l, &slot)) < work;) {
      const long long item = w / tiles;
      const unsigned int tile = (unsigned int)(w - item * tiles);
      const T* y = a.src + item * a.nbands * a.vox;
      const T* approx = l == 0 ? y : slot_item(a, (l - 1) % 2, item);
      T* out = final ? a.dst + item * a.vox : slot_item(a, l % 2, item);
      rec_tile(y, approx, out, a.g, src, a.coef, taps, smem, tile);
    }
  }
}

template <typename T, typename C = compute_t<T>>
int launch_multi(bool rec, const void* src, void* dst, void* ping, void* next,
                 int ndim, int items, int level, const int* n, const int* k,
                 const int* t, const int* left, const int* bit,
                 const void* taps, double coef, cudaStream_t stream) {
  if ((ndim != 2 && ndim != 3) || items < 1 || level < 1)
    return (int)cudaErrorInvalidValue;
  MultiArgs<T, C> a;
  a.src = (const T*)src;
  a.dst = (T*)dst;
  a.ping = (T*)ping;
  a.next = (unsigned long long*)next;
  a.g = make_level<C>(n, k, t, left, bit, taps);
  a.vox = (long long)n[0] * n[1] * n[2];
  a.items = items;
  a.level = level;
  a.nb = 1 << ndim;
  a.nbands = a.nb + (a.nb - 1) * (level - 1);
  a.coef = (C)coef;
  const long long work = (long long)num_tiles(a.g) * items;
  const size_t smem = tile_smem_bytes(a.g, rec);
  if (rec)
    return launch_cooperative(rec_multi_kernel<T, C>, a, work, kThreads,
                              stream, smem, 1);
  return launch_cooperative(dec_multi_kernel<T, C>, a, work, kThreads, stream,
                            smem, 1);
}

int dispatch(int dtype, bool rec, const void* src, void* dst, void* ping,
             void* next, int ndim, int items, int level, const int* n,
             const int* k, const int* t, const int* left, const int* bit,
             const void* taps, double coef, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_multi<float>(rec, src, dst, ping, next, ndim, items, level,
                               n, k, t, left, bit, taps, coef, s);
  if (dtype == 1)
    return launch_multi<__nv_bfloat16>(rec, src, dst, ping, next, ndim, items,
                                       level, n, k, t, left, bit, taps, coef,
                                       s);
  if (dtype == 2)
    return launch_multi<double>(rec, src, dst, ping, next, ndim, items, level,
                                n, k, t, left, bit, taps, coef, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. ndim 2 or 3 spatial axes; n, k, t, left, bit: 3 ints each
// (slot 0 slowest; a 2D array's slot 0 a pass-through of extent 1), as the
// per-level kernels take them, with the analysis's or the synthesis's
// (reversed) taps: 3 * 2 * 76 of the compute type (float for dtypes 0 and
// 1, double for 2), in host memory. items: the batch N >= 1; level L >= 1.
// ping: min(L - 1, 2) * N arrays of the spatial shape (unused at L = 1);
// next: L unsigned 64-bit zeros, the per-level work counters (left
// nonzero). The caller allocates every array on the device and makes it
// current.
// Returns the cudaError_t of the cooperative launch (0 on success), which is
// asynchronous on `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

// x (N, *s) -> bands (N, B, *s); details shrunk by lam > 0.
extern "C" int nddwt_dec_multi(const void* x, void* bands, void* ping,
                               void* next, int dtype, int ndim, int items,
                               int level, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, double lam, void* stream) {
  return dispatch(dtype, false, x, bands, ping, next, ndim, items, level, n,
                  k, t, left, bit, taps, lam, stream);
}

// bands (N, B, *s) -> out (N, *s); scale: the per-level factor.
extern "C" int nddwt_rec_multi(const void* bands, void* out, void* ping,
                               void* next, int dtype, int ndim, int items,
                               int level, const int* n, const int* k,
                               const int* t, const int* left, const int* bit,
                               const void* taps, double scale, void* stream) {
  return dispatch(dtype, true, bands, out, ping, next, ndim, items, level, n,
                  k, t, left, bit, taps, scale, stream);
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
