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
// kernel keeps them (pallas_flat.py:622-628); the approximation, the
// partial bands of an axis group and the synthesis sums stay in the
// compute type.
//
// Design. On the TPU the whole padded array lives in VMEM as an (8, P/8)
// view and every circular shift is a lane and sublane roll. No CTA of an
// H100 holds that and nothing carries over between CTAs, so the array and
// its working copies live in device memory (at the sizes the wrappers
// admit they stay in the 50 MB L2) and one cooperative launch of a
// persistent grid runs the level and iteration loops, with a grid-wide
// barrier between dependent passes (nddwt_grid.cuh). A pass takes one
// group of consecutive axes of one level in one direction; the plan
// (ops/flat.py: _flat_plan) names the groups and the tile, and where a
// level's windows fit shared memory one group holds every axis, so a level
// is one pass:
//
//   analysis   a unit is a tile and a parent node of the group's first
//              axis (both batch items). Its window, the tile plus K_a - 1
//              halo rows on each axis a of the group, is copied into shared
//              memory once (16-byte cp.async pieces, element copies at a
//              row's ends; the periodic wrap resolved in a table of row
//              offsets and one of columns, never per tap; a CTA that keeps
//              its unit from pass to pass builds them once), then the
//              level's band tree runs in shared memory as the TPU kernel's
//              _tree_reduce (pallas_kernels.py:1257): lo/hi along the
//              group's first axis, then the next axis on both halves, and so
//              on. The last axis writes the leaves: the stored bands (the
//              details shrunk jointly over the batch) and the next
//              approximation, or, where later groups follow, the partial
//              bands of the group;
//   synthesis  a unit is a tile, an output node of the group and a batch
//              item. It copies the windows of its 2^m inputs (the bands, or
//              band 0 from the previous level's output, or the previous
//              group's partial sums) at once and runs the tree-expand
//              adjoint (_tree_expand, :1281) in shared memory: the
//              group's first axis on each lo/hi pair, then the next. The
//              last axis writes the level's output, or at the last level
//              the epilogue: FISTA's z/x update and the next iteration's
//              analysis input V.
//
// Every pass writes other arrays than it reads; the approximation, the
// synthesis output and the partial bands ping-pong between two buffers.
// A 2D L3 FISTA iteration makes 3 + 3 passes and 6 grid barriers (the
// per-axis passes of the parent design made 12); a 3D L3 pair in groups of
// two axes 6 + 6 passes and 1 + 6 + 5 = 12 barriers (one after V).
// Persistent CTAs (one wave: occupancy times SMs, at most the largest
// pass's units) walk a pass's units in a fixed order, unit c + i * grid;
// every thread reaches every __syncthreads() and every grid barrier, also
// in a CTA that has no unit in a pass. On an H100 (chip_ab_flat.py,
// PERF.md) a 256^2 pass is about a third grid barrier (~1.6 us), a third
// window copies and a third in-tile passes; 16-byte pieces beat element
// copies (the 256^2 solve by 4 %, the 64^3 pair by 13 %); a hand-written
// barrier, a register cap for more CTAs an SM and runtime tap loops were
// slower.
//
// What bounds it. Bytes, at the sizes it serves: at 256^2 db4 L3 f32 one
// pair reads x and writes the bands and x (1.5 MB, 0.5 us at 3.35 TB/s),
// against 2 K multiply-adds per band element and axis (about 30 MFLOP,
// 0.5 us at 67 TFLOP/s). Neither is what it spends its time on: each pass
// ends at a grid barrier, so barrier latency, the window copies' latency
// and the passes' fill set the time. The design takes one pass per level
// and direction where the windows fit (the parent took one per axis), and
// the host is out of the loop: one launch instead of the per-level route's
// 2 L (the solvers' 2 L + 1 per iteration). The halo is the price: a tile
// window holds prod (t_a + K_a - 1) / t_a times the tile, 2^d windows in
// the synthesis, all read from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include <cstdint>
#include <type_traits>

#include "nddwt_common.cuh"
#include "nddwt_grid.cuh"
#include "nddwt_stream.cuh"  // copy_elem, copy16 (cp.async), cp_commit, cp_wait

namespace {

constexpr int kMaxDim = 8;  // transformed axes a launch may have
// The plan the wrapper lays out (ops/flat.py: _flat_plan): the number of
// axis groups, each group's end axis, the tile extent of each axis, the
// dynamic shared memory in bytes and the units of the largest pass.
constexpr int kPlanInts = 1 + 2 * kMaxDim + 2;
enum Mode { kDec = 0, kRec = 1, kPair = 2, kChain = 3, kFista = 4 };

// One axis of a unit's tree: arrays shaped outer x w x inner become
// outer x t x inner (w = t + K - 1, the axis's window).
struct Step {
  FastDiv inner, t, outer;
  int w, in_size, out_size;  // the axis's window; elements of one array
};

// How the rows of a window whose columns start sh words into the row are
// copied: nw whole 16-byte pieces a row (fw), and the other cols - nw V
// columns one by one (fe), the first `head` of them before the pieces.
struct RowCopy {
  FastDiv fw, fe;
  int nw, head;
};

// One axis group [a0, a1): its window's rows (every axis but the last),
// columns (last-axis elements) and elements; the row pitch in shared
// memory; `shift`: each unit's rows start sh = colt[0] mod V words into the
// pitch (V = 16 / sizeof(C)), so that a piece's source and destination are
// both 16-byte aligned; the row copy for each sh; and where its units'
// tables sit in the table area (analysis, synthesis).
struct Group {
  int a0, a1;
  int rows, cols, win, pitch;
  bool shift;
  RowCopy rc[4];
  int tab[2];
};

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
  // The plan: tiles, groups, the in-tile steps per direction and axis, and
  // the shared-memory words of the two stage buffers X and Y.
  int t[kMaxDim], nt[kMaxDim];
  int ngroups, ntiles, tile_elems, out_rows, xw, yw;
  FastDiv ftile, flast;  // tile_elems, t[ndim - 1]
  Group grp[kMaxDim];
  Step ana[kMaxDim], syn[kMaxDim];
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

// A filter length: 2, 4, 6, 8 unrolled (taps in registers), else 0 (a
// runtime loop over the taps in shared memory).
template <typename F>
__device__ __forceinline__ void by_taps(int K, F f) {
  switch (K) {
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    default: f(std::integral_constant<int, 0>()); break;
  }
}

// lo, hi = sum_j tl[j] p[j S], th[j] p[j S], j ascending (the analysis).
template <int KT, typename C>
__device__ __forceinline__ void dot2(const C* tl, const C* th, const C* p, int S,
                                     int K, C& lo, C& hi) {
  lo = 0;
  hi = 0;
  if constexpr (KT > 0) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const C v = p[j * S];
      lo = mad(tl[j], v, lo);
      hi = mad(th[j], v, hi);
    }
  } else {
    for (int j = 0; j < K; ++j) {
      const C v = p[j * S];
      lo = mad(tl[j], v, lo);
      hi = mad(th[j], v, hi);
    }
  }
}

// sum_j t[j] p[(K - 1 - j) S], j ascending: the adjoint at window position
// c + K - 1 - j of output c.
template <int KT, typename C>
__device__ __forceinline__ C dot_adj(const C* t, const C* p, int S, int K) {
  C acc = 0;
  if constexpr (KT > 0) {
#pragma unroll
    for (int j = 0; j < KT; ++j) acc = mad(t[j], p[(KT - 1 - j) * S], acc);
  } else {
    for (int j = 0; j < K; ++j) acc = mad(t[j], p[(K - 1 - j) * S], acc);
  }
  return acc;
}

template <typename T, typename C>
__device__ __forceinline__ T* band_ptr(const FlatArgs<T, C>& a, T* bands,
                                       int bi, int band) {
  return bands + ((long long)bi * a.nbands + band) * a.numel;
}

__device__ __forceinline__ int wrap_mod(int c, int n) {
  c %= n;
  return c < 0 ? c + n : c;
}

// The unit's tables: tile origin o; rowt[r], the offset of window row r
// (every axis but the last, wrapped); colt[c], the wrapped last-axis index
// of window column c; outr[r], the offset of tile row r at the tile's first
// column, or -1 past the array's end (ragged last tiles compute rows that
// are never stored). `left`: the window starts at o - left on the group's
// axes (K/2 - 1 for the analysis, K/2 for the adjoint).
template <typename T, typename C>
__device__ void unit_tables(const FlatArgs<T, C>& a, const Group& G, const int* o,
                            bool adj, int* rowt, int* colt, int* outr) {
  const int d = a.ndim;
  const int total = G.rows + G.cols + a.out_rows;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    if (i < G.rows) {
      int r = i, off = 0;
      for (int ax = d - 2; ax >= 0; --ax) {
        const bool h = ax >= G.a0 && ax < G.a1;
        const int e = a.t[ax] + (h ? a.k[ax] - 1 : 0);
        const int ia = r % e;
        r /= e;
        const int left = h ? a.k[ax] / 2 - (adj ? 0 : 1) : 0;
        off += wrap_mod(o[ax] + ia - left, a.n[ax]) * a.stride[ax];
      }
      rowt[i] = off;
    } else if (i < G.rows + G.cols) {
      const int c = i - G.rows, ax = d - 1;
      const bool h = ax >= G.a0 && ax < G.a1;
      const int left = h ? a.k[ax] / 2 - (adj ? 0 : 1) : 0;
      colt[c] = wrap_mod(o[ax] + c - left, a.n[ax]);
    } else {
      const int j = i - G.rows - G.cols;
      int r = j, off = o[d - 1];
      bool in = true;
      for (int ax = d - 2; ax >= 0; --ax) {
        const int c = o[ax] + r % a.t[ax];
        r /= a.t[ax];
        in = in && c < a.n[ax];
        off += c * a.stride[ax];
      }
      outr[j] = in ? off : -1;
    }
  }
}

// One window element, and one piece of V = 16 / sizeof(C) of them (16-byte
// aligned in shared memory, V-aligned in the source, never across the
// periodic wrap): cp.async where the source is in the compute type, else
// a load and a conversion (bfloat16 bands, a piece in one 8-byte load).
template <typename C>
__device__ __forceinline__ void copy_one(C* d, const C* s) { copy_elem(d, s); }
__device__ __forceinline__ void copy_one(float* d, const __nv_bfloat16* s) {
  *d = __bfloat162float(*s);
}
template <typename C>
__device__ __forceinline__ void copy_piece(C* d, const C* s) { copy16(d, s); }
__device__ __forceinline__ void copy_piece(float* d, const __nv_bfloat16* s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(s);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One window of a unit into W: column c of row r (from src at rowt[r] +
// colt[c]) at W[r pitch + sh + c]. Two loops, so that no warp splits
// between them: the whole pieces (V columns at a V-aligned word of the row,
// whose first column is V-aligned in the source, so that the V are
// consecutive there: the extent is a multiple of V and the wrap falls
// between pieces), one 16-byte copy each; then the row's other columns
// (its head and tail, or every column of a launch without whole pieces).
template <typename S, typename C>
__device__ __forceinline__ void copy_window(C* W, const S* __restrict__ src, const Group& G,
                                            const int* rowt, const int* colt, int sh) {
  constexpr int V = 16 / sizeof(C);
  const RowCopy& rc = G.rc[sh];
  for (int e = threadIdx.x; e < G.rows * rc.nw; e += kThreads) {
    const int row = fdiv(rc.fw, e), q = e - row * rc.nw;
    const int c = rc.head + q * V;  // at word sh + c, a multiple of V
    copy_piece(W + row * G.pitch + sh + c, src + rowt[row] + colt[c]);
  }
  const int ne = G.cols - rc.nw * V;
  for (int e = threadIdx.x; e < G.rows * ne; e += kThreads) {
    const int row = fdiv(rc.fe, e), j = e - row * ne;
    const int c = j < rc.head ? j : j + rc.nw * V;
    copy_one(W + row * G.pitch + sh + c, src + rowt[row] + colt[c]);
  }
}

// The word offset of a unit's window columns in each row (see Group).
template <typename C>
__device__ __forceinline__ int unit_shift(const Group& G, const int* colt) {
  return G.shift ? colt[0] & (16 / (int)sizeof(C) - 1) : 0;
}

// A unit's tables, in area (g, adj) of the table area, built where the
// area holds another unit's (`key`, in shared memory: a CTA that takes the
// same unit in every pass of a group and direction builds them once a
// launch). The key changes only after a barrier, so the branch is uniform.
template <typename T, typename C>
__device__ __forceinline__ void tables_for(const FlatArgs<T, C>& a, const Group& G,
                                           const int* o, bool adj, int u, int* key,
                                           int* rowt, int* colt, int* outr) {
  if (*key == u) return;
  unit_tables(a, G, o, adj, rowt, colt, outr);
  __syncthreads();
  if (threadIdx.x == 0) *key = u;
}

template <typename T, typename C>
__device__ __forceinline__ void tile_origin(const FlatArgs<T, C>& a, int tile, int* o) {
  for (int ax = a.ndim - 1; ax >= 0; --ax) {
    const int c = tile % a.nt[ax];
    tile /= a.nt[ax];
    o[ax] = c * a.t[ax];
  }
}

__device__ __forceinline__ void flat_sync() { grid_barrier(); }

// One analysis pass: axis group g of one level, from `in` (the
// approximation, or the previous group's partial bands) into the level's
// leaves or this group's partial bands `pout`.
template <typename T, typename C>
__device__ void ana_pass(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps], int g,
                         const C* __restrict__ in, C* __restrict__ pout,
                         C* __restrict__ next, bool final, int off, C lam, int* key) {
  const Group& G = a.grp[g];
  const int d = a.ndim, m = G.a1 - G.a0, B = a.batch, numel = a.numel;
  C* const X = shared_words<C>();
  C* const Y = X + a.xw;
  int* const rowt = reinterpret_cast<int*>(Y + a.yw) + G.tab[0];
  int* const colt = rowt + G.rows;
  int* const outr = colt + G.cols;
  const int units = a.ntiles << G.a0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int r0 = u / a.ntiles;  // the parent node
    int o[kMaxDim];
    tile_origin(a, u - r0 * a.ntiles, o);
    tables_for(a, G, o, false, u, key, rowt, colt, outr);
    const int sh = unit_shift<C>(G, colt);
    // The window of each batch item, B * win words into X.
    for (int bi = 0; bi < B; ++bi)
      copy_window(X + bi * G.win, in + ((long long)r0 * B + bi) * numel, G, rowt, colt, sh);
    cp_commit();
    cp_wait(0);
    __syncthreads();
    // The group's axes but the last, in shared memory: stage s holds
    // B 2^s arrays (local node q, batch item bi at q B + bi); lo of array
    // A goes to A, hi to A + B 2^s.
    C* cur = X;
    C* nxt = Y;
    for (int s = 0; s + 1 < m; ++s) {
      const int ax = G.a0 + s;
      const Step& st = a.ana[ax];
      const int items = (B << s) * st.out_size, S = st.inner.d, tt = st.t.d;
      const C* tl = taps[ax][0];
      const C* th = taps[ax][1];
      by_taps(a.k[ax], [&](auto kt) {
        constexpr int KT = decltype(kt)::value;
        for (int i = threadIdx.x; i < items; i += kThreads) {
          const int rest = fdiv(st.inner, i), ii = i - rest * S;
          const int r2 = fdiv(st.t, rest), c = rest - r2 * tt;
          C lo, hi;
          dot2<KT>(tl, th, cur + (r2 * st.w + c) * S + ii, S, a.k[ax], lo, hi);
          nxt[i] = lo;
          nxt[i + items] = hi;
        }
      });
      __syncthreads();
      C* sw = cur;
      cur = nxt;
      nxt = sw;
    }
    // The group's last axis, into device memory: parent q of 2^(m-1) gives
    // global nodes r0 + (q << a0) (lo) and that plus 2^(a1-1) (hi).
    {
      const int ax = G.a1 - 1;
      const Step& st = a.ana[ax];
      const int par = 1 << (m - 1), S = st.inner.d, tt = st.t.d, tl0 = a.t[d - 1];
      const int lastlim = min(tl0, a.n[d - 1] - o[d - 1]);
      const C* tl = taps[ax][0];
      const C* th = taps[ax][1];
      const bool leaves = G.a1 == d;
      by_taps(a.k[ax], [&](auto kt) {
        constexpr int KT = decltype(kt)::value;
        for (int i = threadIdx.x; i < par * a.tile_elems; i += kThreads) {
          const int q = fdiv(a.ftile, i), p = i - q * a.tile_elems;
          const int row = fdiv(a.flast, p), col = p - row * tl0;
          const int orow = outr[row];
          if (orow < 0 || col >= lastlim) continue;
          const int gi = orow + col;
          const int rest = fdiv(st.inner, p), ii = p - rest * S;
          const int r2 = fdiv(st.t, rest), c = rest - r2 * tt;
          const int base = (r2 * st.w + c) * S + ii + sh;
          C v[2][2];  // [bi][lo/hi]
          for (int bi = 0; bi < B; ++bi)
            dot2<KT>(tl, th, cur + (long long)(q * B + bi) * st.in_size + base, S, a.k[ax],
                     v[bi][0], v[bi][1]);
          const int parent = r0 + (q << G.a0);
          if (!leaves) {
            for (int s = 0; s < 2; ++s)
              for (int bi = 0; bi < B; ++bi)
                pout[((long long)(parent + (s << (G.a1 - 1))) * B + bi) * numel + gi] =
                    v[bi][s];
            continue;
          }
          // The leaves: band 0 (the approximation) and the details, shrunk
          // jointly over the batch.
          for (int s = 0; s < 2; ++s) {
            const int b = parent + (s << (d - 1));
            if (b == 0) {
              for (int bi = 0; bi < B; ++bi) {
                if (final)
                  band_ptr(a, a.bands, bi, 0)[gi] = from_f<T>(v[bi][0]);
                else
                  next[(long long)bi * numel + gi] = v[bi][0];
              }
              continue;
            }
            if (lam > 0) {
              const C mg = B == 2 ? sqrt_c(v[0][s] * v[0][s] + v[1][s] * v[1][s])
                                  : (v[0][s] < 0 ? -v[0][s] : v[0][s]);
              const C f = fmax_c(mg - lam, (C)0) / fmax_c(mg, (C)1e-30);
              for (int bi = 0; bi < B; ++bi) v[bi][s] *= f;
            }
            for (int bi = 0; bi < B; ++bi)
              band_ptr(a, a.bands, bi, off + b - 1)[gi] = from_f<T>(v[bi][s]);
          }
        }
      });
    }
    __syncthreads();
  }
}

// The multilevel analysis of V into a.bands, details shrunk by lam.
template <typename T, typename C>
__device__ void analysis(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps],
                         C lam, int* tab_key) {
  const long long nbe = (long long)a.batch * a.numel;
  C* V = a.work;
  C* A[2] = {a.work + nbe, a.work + 2 * nbe};
  C* P[2] = {a.work + 3 * nbe, a.work + (3 + flat_half(a.ndim)) * nbe};
  const int nb = 1 << a.ndim;
  for (int lvl = 0; lvl < a.level; ++lvl) {
    const C* approx = lvl == 0 ? V : A[(lvl - 1) & 1];
    C* next = A[lvl & 1];
    const bool final = lvl == a.level - 1;
    const int off = dec_detail_offset(a.nbands, nb, lvl);
    for (int g = 0; g < a.ngroups; ++g) {
      ana_pass(a, taps, g, g == 0 ? approx : P[(g - 1) & 1], P[g & 1], next, final, off,
               lam, tab_key + 2 * g);
      flat_sync();
    }
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

// One synthesis pass: axis group g of level lvl (0 = deepest). Its inputs
// are the 2^(d - a0) nodes at the group's first axis: the bands ys
// (storage type; band 0 from acc_in at lvl > 0), or the previous group's
// partial sums pin; its output the 2^(d - a1) nodes of the next group
// (pout), or the level's output (acc_out, or the epilogue at the last
// level).
template <typename T, typename C>
__device__ void syn_pass(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps], int g,
                         const T* __restrict__ ys, const C* __restrict__ acc_in,
                         const C* __restrict__ pin, C* __restrict__ pout,
                         C* __restrict__ acc_out, int lvl, bool last, C mom, int* key) {
  const Group& G = a.grp[g];
  const int d = a.ndim, m = G.a1 - G.a0, B = a.batch, numel = a.numel;
  const int nb = 1 << d;
  C* const X = shared_words<C>();
  C* const Y = X + a.xw;
  int* const rowt = reinterpret_cast<int*>(Y + a.yw) + G.tab[1];
  int* const colt = rowt + G.rows;
  int* const outr = colt + G.cols;
  const bool end = g + 1 == a.ngroups;
  const int units = a.ntiles * B << (d - G.a1);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int rest_u = u / a.ntiles;
    const int bi = rest_u % B, gq = rest_u / B;  // batch item, output node
    int o[kMaxDim];
    tile_origin(a, u - rest_u * a.ntiles, o);
    tables_for(a, G, o, true, u, key, rowt, colt, outr);
    const int sh = unit_shift<C>(G, colt);
    // The windows of the 2^m inputs (local node kk: input node
    // (gq << m) + kk), 2^m * win words into X.
    for (int kk = 0; kk < 1 << m; ++kk) {
      const int node = (gq << m) + kk;
      C* const W = X + kk * G.win;
      if (G.a0 > 0)
        copy_window(W, pin + ((long long)node * B + bi) * numel, G, rowt, colt, sh);
      else if (lvl > 0 && node == 0)
        copy_window(W, acc_in + (long long)bi * numel, G, rowt, colt, sh);
      else
        copy_window(W, ys + ((long long)bi * a.nbands + rec_band_index(nb, lvl, node)) *
                                (long long)numel, G, rowt, colt, sh);
    }
    cp_commit();
    cp_wait(0);
    __syncthreads();
    // Stage s holds 2^(m-s) arrays; arrays 2h (lo) and 2h + 1 (hi) give h.
    C* cur = X;
    C* nxt = Y;
    for (int s = 0; s + 1 < m; ++s) {
      const int ax = G.a0 + s;
      const Step& st = a.syn[ax];
      const int items = (1 << (m - s - 1)) * st.out_size, S = st.inner.d, tt = st.t.d,
                ou = st.outer.d;
      const C* tl = taps[ax][0];
      const C* th = taps[ax][1];
      by_taps(a.k[ax], [&](auto kt) {
        constexpr int KT = decltype(kt)::value;
        for (int i = threadIdx.x; i < items; i += kThreads) {
          const int rest = fdiv(st.inner, i), ii = i - rest * S;
          const int r2 = fdiv(st.t, rest), c = rest - r2 * tt;
          const int h = fdiv(st.outer, r2), oo = r2 - h * ou;
          const C* p0 = cur + (long long)(2 * h) * st.in_size + (oo * st.w + c) * S + ii;
          const C lo = dot_adj<KT>(tl, p0, S, a.k[ax]);
          nxt[i] = lo + dot_adj<KT>(th, p0 + st.in_size, S, a.k[ax]);
        }
      });
      __syncthreads();
      C* sw = cur;
      cur = nxt;
      nxt = sw;
    }
    // The group's last axis, into device memory.
    {
      const int ax = G.a1 - 1;
      const Step& st = a.syn[ax];
      const int S = st.inner.d, tt = st.t.d, tl0 = a.t[d - 1];
      const int lastlim = min(tl0, a.n[d - 1] - o[d - 1]);
      const C* tl = taps[ax][0];
      const C* th = taps[ax][1];
      by_taps(a.k[ax], [&](auto kt) {
        constexpr int KT = decltype(kt)::value;
        for (int p = threadIdx.x; p < a.tile_elems; p += kThreads) {
          const int row = fdiv(a.flast, p), col = p - row * tl0;
          const int orow = outr[row];
          if (orow < 0 || col >= lastlim) continue;
          const int gi = orow + col;
          const int rest = fdiv(st.inner, p), ii = p - rest * S;
          const int r2 = fdiv(st.t, rest), c = rest - r2 * tt;
          const C* p0 = cur + (r2 * st.w + c) * S + ii + sh;
          const C lo = dot_adj<KT>(tl, p0, S, a.k[ax]);
          const C sum = lo + dot_adj<KT>(th, p0 + st.in_size, S, a.k[ax]);
          if (!end)
            pout[((long long)gq * B + bi) * numel + gi] = sum;
          else if (last)
            epilogue(a, bi, gi, sum * a.scale, mom);
          else
            acc_out[(long long)bi * numel + gi] = sum * a.scale;
        }
      });
    }
    __syncthreads();
  }
}

// The multilevel synthesis of `ys` (band-major per batch item, storage
// type) into the epilogue.
template <typename T, typename C>
__device__ void synthesis(const FlatArgs<T, C>& a, const C (*taps)[2][kMaxTaps],
                          const T* ys, C mom, int* tab_key) {
  const long long nbe = (long long)a.batch * a.numel;
  C* A[2] = {a.work + nbe, a.work + 2 * nbe};
  C* P[2] = {a.work + 3 * nbe, a.work + (3 + flat_half(a.ndim)) * nbe};
  for (int lvl = 0; lvl < a.level; ++lvl) {
    const bool last = lvl == a.level - 1;
    for (int g = 0; g < a.ngroups; ++g) {
      syn_pass(a, taps, g, ys, lvl == 0 ? nullptr : A[(lvl - 1) & 1],
               g == 0 ? nullptr : P[(g - 1) & 1], P[g & 1], A[lvl & 1], lvl, last, mom,
               tab_key + 2 * g + 1);
      if (!(last && g + 1 == a.ngroups)) flat_sync();
    }
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, 2)
    flat_kernel(const __grid_constant__ FlatArgs<T, C> a) {
  __shared__ C taps[kMaxDim][2][kMaxTaps];
  __shared__ int tab_key[2 * kMaxDim];  // the unit whose tables area (g, adj) holds
  for (int i = threadIdx.x; i < a.ndim * 2 * kMaxTaps; i += blockDim.x)
    (&taps[0][0][0])[i] = a.taps[i];
  if (threadIdx.x < 2 * kMaxDim) tab_key[threadIdx.x] = -1;
  __syncthreads();
  const unsigned int nbe = a.batch * a.numel;
  C* V = a.work;
  if (a.mode == kRec) {
    synthesis(a, taps, a.bands, (C)0, tab_key);
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
  flat_sync();
  if (a.mode == kDec || a.mode == kPair) {
    analysis(a, taps, a.lam, tab_key);
    if (a.mode == kPair) synthesis(a, taps, a.bands, (C)0, tab_key);
    return;
  }
  for (int i = 0; i < a.n_iter; ++i) {
    analysis(a, taps, a.sched[2 * i], tab_key);
    synthesis(a, taps, a.bands, a.sched[2 * i + 1], tab_key);
    if (i + 1 < a.n_iter) flat_sync();
  }
}

// The plan's derived geometry into `a` (tiles, groups, the in-tile steps,
// the stage buffers), checked against what the wrapper computed: the
// dynamic shared memory (bytes) and the units of the largest pass. Returns
// 0, or cudaErrorInvalidValue where the plan is malformed or disagrees.
template <typename T, typename C>
int flat_layout(FlatArgs<T, C>& a, const int* plan, bool aligned, size_t* smem,
                long long* units) {
  constexpr int V = 16 / sizeof(C);
  const int d = a.ndim, ng = plan[0];
  if (ng < 1 || ng > d) return (int)cudaErrorInvalidValue;
  a.ngroups = ng;
  long long tiles = 1, telems = 1, orows = 1;
  for (int ax = 0; ax < d; ++ax) {
    const int t = plan[1 + kMaxDim + ax];
    if (t < 1 || t > a.n[ax]) return (int)cudaErrorInvalidValue;
    a.t[ax] = t;
    a.nt[ax] = (a.n[ax] + t - 1) / t;
    tiles *= a.nt[ax];
    telems *= t;
    if (ax + 1 < d) orows *= t;
  }
  long long xw = 0, yw = 0, iw = 0, umax = 0;
  int prev = 0;
  for (int g = 0; g < ng; ++g) {
    Group& G = a.grp[g];
    G.a0 = prev;
    G.a1 = plan[1 + g];
    if (G.a1 <= prev || G.a1 > d) return (int)cudaErrorInvalidValue;
    prev = G.a1;
    const int m = G.a1 - G.a0;
    long long e[kMaxDim], rows = 1;
    for (int ax = 0; ax < d; ++ax) {
      e[ax] = a.t[ax] + (ax >= G.a0 && ax < G.a1 ? a.k[ax] - 1 : 0);
      if (ax + 1 < d) rows *= e[ax];
    }
    // A group with the last axis's halo, on an extent that is a multiple of
    // V, pads its rows to room for V - 1 words of shift (ops/flat.py:
    // window_pitch).
    G.shift = G.a1 == d && a.n[d - 1] % V == 0;
    const long long pitch = G.shift ? (e[d - 1] + 2 * V - 2) / V * V : e[d - 1];
    const long long win = rows * pitch;
    if (win << (m > 0 ? m : 0) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    G.rows = (int)rows;
    G.cols = (int)e[d - 1];
    G.win = (int)win;
    G.pitch = (int)pitch;
    // Whole pieces where the launch is aligned and the rows start at a
    // V-aligned column of the source: every unit of a shifted group, the
    // units of another where its tiles are V-aligned (then sh is 0).
    const bool vec = aligned && a.n[d - 1] % V == 0 && pitch % V == 0;
    for (int sh = 0; sh < 4; ++sh) {
      RowCopy& rc = G.rc[sh];
      const int lead = (V - sh % V) % V;
      rc.nw = vec && sh < V && (G.shift || sh == 0) && G.cols >= lead + V
                  ? (G.cols - lead) / V : 0;
      rc.head = rc.nw > 0 ? lead : G.cols;
      rc.fw = make_div((unsigned)(rc.nw > 0 ? rc.nw : 1));
      rc.fe = make_div((unsigned)(G.cols - rc.nw * V > 0 ? G.cols - rc.nw * V : 1));
    }
    for (int adj = 0; adj < 2; ++adj) {  // the group's two table areas
      G.tab[adj] = (int)iw;
      iw += rows + e[d - 1] + orows;
    }
    for (int adj = 0; adj < 2; ++adj) {
      long long cur[kMaxDim];
      for (int ax = 0; ax < d; ++ax) cur[ax] = e[ax];
      cur[d - 1] = pitch;
      for (int s = 0; s < m; ++s) {
        const int ax = G.a0 + s;
        long long inner = 1, outer = 1;
        for (int b = ax + 1; b < d; ++b) inner *= cur[b];
        for (int b = 0; b < ax; ++b) outer *= cur[b];
        Step& st = adj ? a.syn[ax] : a.ana[ax];
        st.inner = make_div((unsigned)inner);
        st.t = make_div((unsigned)a.t[ax]);
        st.outer = make_div((unsigned)outer);
        st.w = (int)cur[ax];
        st.in_size = (int)(outer * cur[ax] * inner);
        st.out_size = (int)(outer * a.t[ax] * inner);
        const long long words = (adj ? 1LL << (m - s) : (long long)a.batch << s) * st.in_size;
        long long& buf = s % 2 == 0 ? xw : yw;
        if (words > buf) buf = words;
        cur[ax] = a.t[ax];
      }
    }
    const long long ua = tiles << G.a0, us = (tiles * a.batch) << (d - G.a1);
    umax = ua > umax ? ua : umax;
    umax = us > umax ? us : umax;
  }
  if (prev != d) return (int)cudaErrorInvalidValue;
  // Every in-tile index stays below the stage buffers' words.
  if (xw + yw >= (1LL << 28) || umax >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.ntiles = (int)tiles;
  a.tile_elems = (int)telems;
  a.out_rows = (int)orows;
  a.ftile = make_div((unsigned)telems);
  a.flast = make_div((unsigned)a.t[d - 1]);
  a.xw = (int)xw;
  a.yw = (int)yw;
  *smem = (size_t)(xw + yw) * sizeof(C) + (size_t)iw * sizeof(int);
  *units = umax;
  if ((long long)*smem != plan[kPlanInts - 2] || umax != plan[kPlanInts - 1])
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, typename C = compute_t<T>>
int launch_flat(int mode, const void* x, const void* mask, void* bands,
                void* out, void* z, void* work, const void* taps,
                const void* sched, int ndim, int batch, int level, int n_iter,
                const int* n, const int* k, double lam, double step,
                double scale, cudaStream_t stream, const int* plan) {
  if (ndim < 1 || ndim > kMaxDim || (batch != 1 && batch != 2) || level < 1 ||
      plan == nullptr)
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
  // Whole pieces need 16-byte aligned compute-type scratch and bands
  // aligned to V of their elements.
  constexpr int V = 16 / sizeof(C);
  const bool aligned = reinterpret_cast<uintptr_t>(work) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(bands) % (V * sizeof(T)) == 0;
  size_t smem = 0;
  long long units = 0;
  const int err = flat_layout(a, plan, aligned, &smem, &units);
  if (err) return err;
  return launch_cooperative(flat_kernel<T, C>, a, units, kThreads, stream, smem, 1);
}

template <typename T>
int dispatch(int mode, const void* x, const void* mask, void* bands, void* out,
             void* z, void* work, const void* taps, const void* sched, int ndim,
             int batch, int level, int n_iter, const int* n, const int* k,
             double lam, double step, double scale, void* stream, const int* plan) {
  return launch_flat<T>(mode, x, mask, bands, out, z, work, taps, sched, ndim,
                        batch, level, n_iter, n, k, lam, step, scale,
                        (cudaStream_t)stream, plan);
}

int dispatch_dtype(int dtype, int mode, const void* x, const void* mask,
                   void* bands, void* out, void* z, void* work,
                   const void* taps, const void* sched, int ndim, int batch,
                   int level, int n_iter, const int* n, const int* k,
                   double lam, double step, double scale, void* stream,
                   const int* plan) {
  if (dtype == 0)
    return dispatch<float>(mode, x, mask, bands, out, z, work, taps, sched,
                           ndim, batch, level, n_iter, n, k, lam, step, scale,
                           stream, plan);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(mode, x, mask, bands, out, z, work, taps,
                                   sched, ndim, batch, level, n_iter, n, k,
                                   lam, step, scale, stream, plan);
  if (dtype == 2)
    return dispatch<double>(mode, x, mask, bands, out, z, work, taps, sched,
                            ndim, batch, level, n_iter, n, k, lam, step, scale,
                            stream, plan);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. ndim <= kMaxDim transformed axes of extents n (slowest
// first) and tap counts k (2 <= k <= min(76, n)); batch 1, or 2 for a
// split re/im pair; taps: ndim * 2 * 76 of the compute type (float for
// dtypes 0 and 1, double for 2) in device memory. work: nddwt_flat_work_words
// words of the compute type. plan: nddwt_flat_plan_ints host ints (the
// last argument; ops/flat.py: _flat_plan). The caller allocates every
// array on the device and makes it current. Returns the cudaError_t of the
// cooperative launch (0 on success), which is asynchronous on `stream`.
extern "C" int nddwt_flat_max_dim() { return kMaxDim; }
extern "C" int nddwt_flat_max_taps() { return kMaxTaps; }
extern "C" int nddwt_flat_plan_ints() { return kPlanInts; }
extern "C" long long nddwt_flat_work_words(int ndim, long long batch_numel) {
  return flat_work_words(ndim, batch_numel);
}

// mode 0 (dec): x -> bands. 1 (rec): bands -> out. 2 (pair): x -> bands
// (details shrunk by lam) -> out. scale: the synthesis's per-level factor.
extern "C" int nddwt_flat_pair(int mode, const void* x, void* bands, void* out,
                               void* work, const void* taps, int dtype,
                               int ndim, int batch, int level, const int* n,
                               const int* k, double lam, double scale,
                               void* stream, const int* plan) {
  if (mode < kDec || mode > kPair) return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, mode, x, nullptr, bands, out, nullptr, work,
                        taps, nullptr, ndim, batch, level, 0, n, k, lam, 0.0,
                        scale, stream, plan);
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
                               double scale, void* stream, const int* plan) {
  if ((mode != kChain && mode != kFista) || n_iter < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, mode, x, mask, bands, out, z, work, taps, sched,
                        ndim, batch, level, n_iter, n, k, 0.0, step, scale,
                        stream, plan);
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
