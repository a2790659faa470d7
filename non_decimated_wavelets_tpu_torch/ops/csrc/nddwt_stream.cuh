// The two streamed bodies of the level and lead-stage kernels: the synthesis
// (stream_syn), shared by nddwt_rec_level (nddwt_level.cu) and
// nddwt_lead_adj (nddwt_4d.cu), and the analysis (stream_ana, below), shared
// by nddwt_dec_level and nddwt_lead_dec. In both a CTA owns an output column
// of (T1, T2) on slots 1 and 2 and a chunk of C outputs along slot 0, and
// walks slot 0 one input plane at a time, copying each window once through
// the same ring of asynchronous copies (StreamCopy).
//
// The launch is over a 3-slot view (LevelT: extents n, taps k, left halo,
// band bit and halo-padded flag per slot; t = (C, T1, T2), T2 a power of
// two and T1 * T2 = kThreads * items). Output group gi (of `groups`, one
// view's extent apart in `out`) is
//
//   out[gi] = scale * sum_{s0, s1, s2} adj0_{s0} adj1_{s1} adj2_{s2} band(s, gi)
//
// where band(s, gi) = y[src.idx[(s0 << bit0 | s1 << bit1 | s2 << bit2) + 4 gi]]
// (index -1: the approx array), and adj_a is the K-tap correlation along slot
// a with the taps as given (already reversed: the adjoint with the mirrored
// halo). A slot with one tap is a pass-through (no band split, no halo).
// The views:
//
//   nddwt_rec_level 3D  (n0, n1, n2), halos on all three slots, one group;
//   nddwt_rec_level 2D  (n0, 1, n1): slot 1 is the pass-through;
//   nddwt_lead_adj      (X, Y, Z*T): slot 2 is the pass-through, groups = the
//                       lane bands, band s0 + 2 s1 + 4 gi.
//
// Per input plane r of the chunk (C + K0 - 1 of them) and per s0, the CTA
// runs the in-plane adjoint on the plane windows of the bands (s0, s1, s2):
// along slot 2 into an intermediate Q, then along slot 1 into the plane P
// (P in registers, `items` elements per thread); then it scatters P into a
// ring of K0 partial output planes along slot 0 (R[m] += tap0[K0-1-m] * P).
// After both s0 the front of the ring is a finished output plane: written
// out, and the ring shifts. A band plane is read once per chunk plus
// K0 - 1 halo planes at its start.
//
// Copies: each window (T1 + K1 - 1 rows of T2 + K2 - 1, in the storage
// type) is copied asynchronously (cp.async) into a ring of up to
// kStreamMaxStages buffers, stages - 1 windows ahead of the one computed,
// one barrier per window. The input offset of every window row is computed
// once per CTA (the rows are the same in every plane and band); a row is
// copied in 16-byte pieces where the input rows are 16-byte aligned (a piece
// never straddles the periodic wrap then, so only its first column is
// wrapped), element by element otherwise (bfloat16 elements by plain loads:
// cp.async copies 4, 8 or 16 bytes). No index is divided per element. The
// halo-padded mode reads a padded slot at position + left without wrapping;
// both bodies read its flags once per CTA and per window, never per
// element, so it is a runtime flag.
//
// A CTA's unit is its origin (o2, o1, p0) in the view: the level and
// lead-stage kernels take their block's (o2 = -1), one unit a CTA; the
// multilevel kernels (nddwt_multi.cu) walk a persistent grid over the units
// of every level and item. Their 2D view (n0, N, n1) folds a batch of N items into
// the pass-through slot 1 (FOLD): a window row is then an item, each array
// steps from item to item by its own stride (Fold), and a plane tile covers
// T1 items' rows.
//
// Filter lengths 2, 4, 6, 8 (db1-db4, the same K on every slot that has a
// halo: stream_unrolled) run with the tap loops unrolled, the taps of the
// current pass in registers, the ring in registers and 4 plane elements a
// thread on consecutive rows (the slot-1 pass loads 4 + K - 1 rows for
// 4 K taps); any other filters run with runtime tap loops, the ring in
// shared memory and one element a thread. Two CTAs per SM (128 registers).
//
// What bounds it on an H100: neither bytes nor flops. At 256^3 db4 f32 a
// level moves 0.6 GB (0.18 ms at 3.35 TB/s) and does about 190 FMAs per
// output; the kernel takes about 7x the bound, and builds that leave out the
// copies or the passes each take about half of its time: the two do not
// overlap, and a ring of two window buffers instead of four changes the time
// by 3 % or less. nddwt_rec_level's 3D views with filters of 2 to 8 taps
// therefore run the plane body instead (nddwt_plane.cuh: bulk row copies
// completing on an mbarrier, one stage per plane and s0, slot 1 before slot
// 2); this body keeps the 2D levels, nddwt_lead_adj, runtime filter lengths
// and the multilevel kernels.

#pragma once

#include <cstdint>
#include <type_traits>

#include "nddwt_common.cuh"

namespace {

constexpr int kStreamBands = 16;
// Window buffers in flight: up to kStreamMaxStages where they fit the
// budget (stream_stages), at least 2.
constexpr int kStreamMaxStages = 4;
constexpr size_t kStreamSmemBudget = 200 * 1024;

struct StreamSources {
  long long idx[kStreamBands];  // band d's index into y; -1 reads approx
};

// The item strides (elements) of a folded view (n0, N, n1): the input (the
// analysis's x, the synthesis's bands y), the synthesis's approx array, the
// output (the analysis's bands, the synthesis's out) and the analysis's
// approximation. Within an item a band is n0 n1 elements and a plane n1.
struct Fold {
  long long src, approx, dst, adst;
};

// Elements of P per thread: the register ring holds items * KT words.
constexpr int kStreamItems = 4;
template <int KT>
__host__ __device__ constexpr int stream_items() {
  return KT > 0 ? kStreamItems : 1;
}

// The unrolled filter length of a launch, or 0 (runtime loops): the same
// length K of 2, 4, 6 or 8 on every slot that has a halo.
__host__ __device__ inline int stream_unrolled(const int* k) {
  const int K = k[0];
  if (K != 2 && K != 4 && K != 6 && K != 8) return 0;
  return (k[1] == 1 || k[1] == K) && (k[2] == 1 || k[2] == K) ? K : 0;
}

// Shared memory of a launch, in bytes: the input offsets of the window's
// rows, `stages` window buffers (storage type T, rows of ws elements), the
// slot-2 intermediate Q (only when slots 1 and 2 both have a halo) and, for
// runtime filter lengths, the ring. `bands`: the in-plane bands one walk of
// the analysis keeps (1 for the synthesis), which hold (bands + 1) / 2
// slices of Q and a ring of k0 planes per band.
struct StreamLayout {
  int ws;            // window row stride, elements (a multiple of 16 bytes)
  size_t rows, win, q, ring, total;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

template <typename T, typename C>
__host__ __device__ StreamLayout stream_layout(const LevelT<C>& g, bool smem_ring,
                                               int stages, int bands = 1) {
  constexpr int V = 16 / sizeof(T);
  StreamLayout L;
  const int ea1 = g.t[1] + g.k[1] - 1;
  L.ws = (g.t[2] + g.k[2] - 1 + V - 1 + V - 1) / V * V;
  L.rows = round16((size_t)ea1 * sizeof(long long));
  L.win = round16((size_t)ea1 * L.ws * sizeof(T));
  L.q = g.k[1] > 1 && g.k[2] > 1
            ? round16((size_t)(bands + 1) / 2 * ea1 * g.t[2] * sizeof(C))
            : 0;
  L.ring = smem_ring ? (size_t)g.k[0] * bands * g.t[1] * g.t[2] * sizeof(C) : 0;
  L.total = L.rows + stages * L.win + L.q + L.ring;
  return L;
}

// The most window buffers (up to kStreamMaxStages, at least 2) whose layout
// fits kStreamSmemBudget.
template <typename T, typename C>
__host__ __device__ int stream_stages(const LevelT<C>& g, bool smem_ring,
                                      int bands = 1) {
  int s = kStreamMaxStages;
  while (s > 2 && stream_layout<T>(g, smem_ring, s, bands).total > kStreamSmemBudget)
    --s;
  return s;
}

// p mod n for -n <= p < 2n: every window position of a chunk or column is
// there (the loads stop at the last output's halo, and K <= n).
__device__ __forceinline__ int wrap2(int p, int n) {
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_elem(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
// A plain load: the multilevel kernels read in one level what other CTAs
// wrote in the level before, so no load of theirs may take the read-only
// path (ld.global.nc); chip_ab_multi.py counts such loads in each build.
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  *dst = *src;
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (< kStreamMaxStages) of this thread's newest copy
// groups are still in flight.
__device__ __forceinline__ void cp_wait(int n) {
  static_assert(kStreamMaxStages <= 6, "cp_wait takes n < 5");
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// The copy side of both bodies: a CTA copies the window of one input plane,
// E1 rows (slot 1) of E2 columns (slot 2) starting at column c0, into a
// buffer whose rows are ws elements long, column c0 at row offset sh. The
// input offset of every window row is computed once per CTA (the rows are
// the same in every plane and band); a row is copied in 16-byte pieces where
// the input rows are 16-byte aligned (a piece never straddles the periodic
// wrap then: n2 is a multiple of V, so the wrap falls between pieces, and
// only its first column is wrapped), element by element otherwise. FOLD: a
// window row is an item, row_off holds its index and issue() its array's
// item stride.
template <typename T, bool FOLD = false>
struct StreamCopy {
  const long long* row_off;  // the input offset of each window row (shared)
  int E1, E2, c0, n2, sh, head, ws;
  bool inner2, vec;

  __device__ __forceinline__ int col(int c) const {
    return inner2 ? c : wrap2(c, n2);
  }

  // Issue the asynchronous copies of the window of the input plane at
  // `plane`, of an array based at `base` (folded: whose items are `item`
  // elements apart), into W.
  __device__ __forceinline__ void issue(T* W, const T* base, const T* plane,
                                        long long item = 0) const {
    constexpr int V = 16 / sizeof(T);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool v = vec && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
    const int hd = v ? min(head, E2) : E2;
    const int nv = v ? (E2 - hd) / V : 0;
    const int tail = hd + nv * V;
    for (int l1 = warp; l1 < E1; l1 += kThreads / 32) {
      const T* row = plane + (FOLD ? row_off[l1] * item : row_off[l1]);
      T* srow = W + l1 * ws + sh;
      for (int i = lane; i < hd; i += 32) copy_elem(srow + i, row + col(c0 + i));
      for (int u = lane; u < nv; u += 32)
        copy16(srow + hd + u * V, row + col(c0 + hd + u * V));
      for (int i = tail + lane; i < E2; i += 32) copy_elem(srow + i, row + col(c0 + i));
    }
  }
};

// A CTA's copies, whose window of E1 x E2 starts at rows o1 - left1 and
// columns o2 - left2 (on a halo-padded slot at o1 and o2 of the padded
// input, unwrapped); m2 is the input's row length (folded: 1, row_off holds
// the items). Fills row_off and waits for it.
template <typename T, bool FOLD = false, typename C>
__device__ StreamCopy<T, FOLD> stream_copy(const LevelT<C>& g, long long* row_off, int o1,
                                           int o2, int E1, int E2, int ws, long long m2,
                                           bool pad1, bool pad2) {
  constexpr int V = 16 / sizeof(T);
  for (int l1 = threadIdx.x; l1 < E1; l1 += kThreads) {
    const int q = o1 - g.left[1] + l1;
    row_off[l1] = (pad1 ? q + g.left[1] : wrap2(q, g.n[1])) * m2;
  }
  __syncthreads();
  StreamCopy<T, FOLD> cp;
  cp.row_off = row_off;
  cp.E1 = E1;
  cp.E2 = E2;
  cp.c0 = pad2 ? o2 : o2 - g.left[2];
  cp.n2 = g.n[2];
  cp.inner2 = pad2 || (cp.c0 >= 0 && cp.c0 + E2 <= g.n[2]);
  cp.sh = ((cp.c0 % V) + V) % V;  // column c0 sits at row offset sh
  cp.head = (V - cp.sh) % V;      // elements before the first 16-byte piece
  cp.ws = ws;
  cp.vec = (FOLD ? g.n[2] : m2) % V == 0;  // folded: item strides are multiples of n1
  return cp;
}

// The taps of one pass, tp[j] = src[j]: KT > 0 copies them into registers
// and unrolls the tap loop; KT == 0 reads them from shared memory in a
// runtime loop of K.
template <int KT, typename C>
struct Taps {
  C r[KT > 0 ? KT : 1];
  const C* s;
  __device__ __forceinline__ explicit Taps(const C* src) : s(src) {
    if constexpr (KT > 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j) r[j] = src[j];
    }
  }
  // sum_j tp[j] * p[j * stride]
  template <typename S>
  __device__ __forceinline__ C dot(const S* p, int stride, int K) const {
    C acc = 0;
    if constexpr (KT > 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j) acc = mad(r[j], to_f(p[j * stride]), acc);
    } else {
      for (int j = 0; j < K; ++j) acc = mad(s[j], to_f(p[j * stride]), acc);
    }
    return acc;
  }
  // tp[K - 1 - m]: the slot-0 tap that input plane r gives ring entry m
  __device__ __forceinline__ C rev(int m, int K) const {
    if constexpr (KT > 0)
      return r[KT - 1 - m];
    else
      return s[K - 1 - m];
  }
};

// The synthesis of the unit at (o2, o1, p0), or of the CTA's block where
// o2 < 0; fold: the item strides of a folded view (FOLD only).
template <typename T, int KT, bool FOLD, typename C>
__device__ void stream_syn(const T* __restrict__ y, const T* __restrict__ approx,
                           T* __restrict__ out, const LevelT<C>& g,
                           const StreamSources& src, int groups, C scale,
                           int stages, C (*taps)[2][kMaxTaps],
                           unsigned char* smem, int o2, int o1, int p0,
                           const Fold& fold) {
  constexpr int NI = stream_items<KT>();
  using Off = std::conditional_t<FOLD, long long, int>;  // an element's output offset
  const StreamLayout L = stream_layout<T>(g, KT == 0, stages);
  long long* const row_off = reinterpret_cast<long long*>(smem);
  unsigned char* const wins = smem + L.rows;
  C* const Q = reinterpret_cast<C*>(wins + stages * L.win);
  C* const ring_s = reinterpret_cast<C*>(wins + stages * L.win + L.q);

  const int K0 = KT > 0 ? KT : g.k[0];
  const int K1 = g.k[1], K2 = g.k[2];
  const int T1 = g.t[1], T2 = g.t[2];
  const int lg2 = 31 - __clz(T2);
  const int tid = threadIdx.x;
  if (o2 < 0) {  // the level kernels' unit: their block's
    o2 = blockIdx.x * T2, o1 = blockIdx.y * T1, p0 = blockIdx.z * g.t[0];
  }
  const int w2 = min(T2, g.n[2] - o2), w1 = min(T1, g.n[1] - o1);
  const int cc = min(g.t[0], g.n[0] - p0);
  const int E1 = w1 + K1 - 1, E2 = w2 + K2 - 1;  // the window loaded
  const bool pad0 = g.pad[0];
  // Input row, plane and band strides, output band and plane strides; a
  // folded view's rows are items (each array's own stride, fold) and its bands
  // and planes an item's.
  const long long m2 = FOLD ? 1 : in_extent(g, 2);
  const long long plane_in = FOLD ? g.n[2] : (long long)in_extent(g, 1) * m2;
  const long long ivox = FOLD ? (long long)g.n[0] * g.n[2] : in_vox(g);
  const long long vox = FOLD ? ivox : (long long)g.n[0] * g.n[1] * g.n[2];
  const long long nplane = FOLD ? g.n[2] : (long long)g.n[1] * g.n[2];
  const int lgs1 = K1 > 1 ? 1 : 0, lgs2 = K2 > 1 ? 1 : 0;
  const int lgpp = 1 + lgs1 + lgs2;  // log2 windows per plane (s0, s1, s2)
  const int R = cc + K0 - 1;         // input planes per group
  const int nw = groups * R << lgpp;

  // A window's place in the walk: group, input plane, and (s0, s1, s2) as
  // the bits of sub; advanced one window at a time.
  struct Pos {
    int gi, r, sub;
  };
  const int per_plane = 1 << lgpp;
  auto advance = [&](Pos& p) {
    if (++p.sub == per_plane) {
      p.sub = 0;
      if (++p.r == R) {
        p.r = 0;
        ++p.gi;
      }
    }
  };

  const StreamCopy<T, FOLD> cp = stream_copy<T, FOLD>(g, row_off, o1, o2, E1, E2, L.ws,
                                                      m2, g.pad[1], g.pad[2]);
  const int ws = L.ws, sh = cp.sh;
  // Issue the asynchronous copies of the window at p into buffer `buf`.
  auto issue = [&](int buf, const Pos& p) {
    const int s2 = p.sub & lgs2, s1 = (p.sub >> lgs2) & lgs1,
              s0 = p.sub >> (lgs1 + lgs2);
    const int band =
        ((s0 << g.bit[0]) | (s1 << g.bit[1]) | (s2 << g.bit[2])) + 4 * p.gi;
    const long long id = src.idx[band];
    const T* base = id < 0 ? approx : y + id * ivox;
    const int pp = p0 - g.left[0] + p.r;
    const int g0 = pad0 ? pp + g.left[0] : wrap2(pp, g.n[0]);
    cp.issue(reinterpret_cast<T*>(wins + buf * L.win), base, base + g0 * plane_in,
             id < 0 ? fold.approx : fold.src);
  };

  // This thread's plane elements: NI consecutive rows of column tid % T2
  // (the slot-1 pass then loads NI + K1 - 1 rows for NI * K1 taps); a plane
  // of fewer than NI rows (a 2D level) takes columns tid + kThreads i.
  // Per element: its place in an output plane and whether it is inside.
  int c1[NI], c2[NI];
  Off po[NI];
  unsigned inside = 0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (T1 >= NI) {
      c1[i] = (tid >> lg2) * NI + i;
      c2[i] = tid & (T2 - 1);
    } else {
      const int f = tid + kThreads * i;
      c1[i] = f >> lg2;
      c2[i] = f & (T2 - 1);
    }
    if constexpr (FOLD)
      po[i] = (o1 + c1[i]) * fold.dst + o2 + c2[i];
    else
      po[i] = (o1 + c1[i]) * g.n[2] + o2 + c2[i];  // a plane holds < 2^31
    if (c1[i] < w1 && c2[i] < w2) inside |= 1u << i;
  }
  C P[NI];
  C ring[KT > 0 ? KT : 1][NI];
  int hd_slot = 0;  // the shared-memory ring's front (KT == 0)

  // stages - 1 windows ahead: window w + stages - 1 goes into the buffer
  // that window w - 1 used, which every thread has left at the barrier.
  Pos ahead{0, 0, 0}, at{0, 0, 0};  // the window issued next, computed next
  int buf_ahead = 0, buf_at = 0;      // their buffers
  for (int w = 0; w < stages - 1; ++w) {
    if (w < nw) {
      issue(buf_ahead++, ahead);
      advance(ahead);
    }
    cp_commit();
  }
  for (int w = 0; w < nw; ++w, advance(at), buf_at = buf_at + 1 == stages ? 0 : buf_at + 1) {
    cp_wait(stages - 2);
    __syncthreads();  // window w has arrived; window w - 1 and Q are consumed
    if (w + stages - 1 < nw) {
      if (buf_ahead == stages) buf_ahead = 0;
      issue(buf_ahead++, ahead);
      advance(ahead);
    }
    cp_commit();

    const int gi = at.gi, r = at.r, sub = at.sub;
    const int s2 = sub & lgs2, s1 = (sub >> lgs2) & lgs1, s0 = sub >> (lgs1 + lgs2);
    const T* W = reinterpret_cast<const T*>(wins + buf_at * L.win);
    if (r == 0 && sub == 0) {  // a new group: an empty ring
      if constexpr (KT > 0) {
#pragma unroll
        for (int m = 0; m < KT; ++m)
#pragma unroll
          for (int i = 0; i < NI; ++i) ring[m][i] = 0;
      } else {
        for (int m = 0; m < K0; ++m) ring_s[m * T1 * T2 + tid] = 0;
        hd_slot = 0;
      }
    }
    if (s1 == 0 && s2 == 0) {
#pragma unroll
      for (int i = 0; i < NI; ++i) P[i] = 0;
    }
    if (K1 > 1 && K2 > 1) {
      // Slot 2 into Q over the loaded rows, then slot 1 into P.
      const Taps<KT, C> t2(taps[2][s2]);
#pragma unroll 1
      for (int f = tid; f < E1 * T2; f += kThreads) {
        const int l1 = f >> lg2, c = f & (T2 - 1);
        const C v = t2.dot(W + l1 * ws + sh + c, 1, K2);
        Q[f] = s2 == 0 ? v : Q[f] + v;
      }
      if (s2 == 1) {
        __syncthreads();  // Q is complete
        const Taps<KT, C> t1(taps[1][s1]);
#pragma unroll
        for (int i = 0; i < NI; ++i)
          P[i] += t1.dot(Q + c1[i] * T2 + c2[i], T2, K1);
      }
    } else if (K1 == 1) {
      // Slot 1 passes through (a 2D level): the window is one row, or one
      // row an item where the batch is folded there.
      const Taps<KT, C> t2(taps[2][s2]);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        P[i] += t2.dot(W + (FOLD ? c1[i] * ws : 0) + sh + c2[i], 1, K2);
    } else {
      // Slot 2 passes through (the lead stage): slot 1 from the window.
      const Taps<KT, C> t1(taps[1][s1]);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        P[i] += t1.dot(W + c1[i] * ws + sh + c2[i], ws, K1);
    }
    if (s1 == lgs1 && s2 == lgs2) {
      // Scatter P along slot 0; after s0 = 1 the ring's front is finished:
      // output plane p0 + r - (K0 - 1) of the chunk.
      const Taps<KT, C> t0(taps[0][s0]);
      const bool emit = s0 == 1 && r >= K0 - 1;
      T* dst = out + gi * vox + (emit ? (long long)(p0 + r - (K0 - 1)) * nplane : 0);
      if constexpr (KT > 0) {
#pragma unroll
        for (int m = 0; m < KT; ++m)
#pragma unroll
          for (int i = 0; i < NI; ++i) ring[m][i] = mad(t0.rev(m, KT), P[i], ring[m][i]);
        if (s0 == 1) {
          if (emit) {
#pragma unroll
            for (int i = 0; i < NI; ++i)
              if (inside >> i & 1) dst[po[i]] = from_f<T>(ring[0][i] * scale);
          }
#pragma unroll
          for (int m = 0; m < KT - 1; ++m)
#pragma unroll
            for (int i = 0; i < NI; ++i) ring[m][i] = ring[m + 1][i];
#pragma unroll
          for (int i = 0; i < NI; ++i) ring[KT - 1][i] = 0;
        }
      } else {
        const int tt = T1 * T2;
        int slot = hd_slot;
        for (int m = 0; m < K0; ++m) {
          C* e = ring_s + slot * tt + tid;
          *e = mad(t0.rev(m, K0), P[0], *e);
          if (++slot == K0) slot = 0;
        }
        if (s0 == 1) {
          C* e = ring_s + hd_slot * tt + tid;
          if (emit && (inside & 1)) dst[po[0]] = from_f<T>(*e * scale);
          *e = 0;
          if (++hd_slot == K0) hd_slot = 0;
        }
      }
    }
  }
}

// The kernel of one instantiation: the taps copied to shared memory (the
// passes load them from there into registers), then the body. Two CTAs per
// SM: at most 128 registers a thread.
template <typename T, int KT, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    stream_syn_kernel(const T* __restrict__ y, const T* __restrict__ approx,
                      T* __restrict__ out, const __grid_constant__ LevelT<C> g,
                      const __grid_constant__ StreamSources src, int groups,
                      C scale, int stages) {
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  stream_syn<T, KT, false>(y, approx, out, g, src, groups, scale, stages, taps,
                           reinterpret_cast<unsigned char*>(shared_words<C>()), -1,
                           -1, -1, Fold{});
}

template <typename T, typename C = compute_t<T>>
auto stream_kernel_for(int kt) {
  switch (kt) {
    case 2: return stream_syn_kernel<T, 2, C>;
    case 4: return stream_syn_kernel<T, 4, C>;
    case 6: return stream_syn_kernel<T, 6, C>;
    case 8: return stream_syn_kernel<T, 8, C>;
    default: return stream_syn_kernel<T, 0, C>;
  }
}

// Launch one streamed synthesis over the view g (t = (C, T1, T2)). Returns
// the cudaError_t of the launch.
template <typename T, typename C = compute_t<T>>
int launch_stream(const T* y, const T* approx, T* out, const LevelT<C>& g,
                  const StreamSources& src, int groups, C scale,
                  cudaStream_t stream) {
  const int kt = stream_unrolled(g.k);
  const int t2 = g.t[2];
  if (g.t[0] < 1 || g.t[1] < 1 || t2 < 1 || (t2 & (t2 - 1)) ||
      g.t[1] * t2 != kThreads * (kt > 0 ? kStreamItems : 1) || g.k[0] < 2 ||
      groups < 1 || groups > kStreamBands / 4)
    return (int)cudaErrorInvalidValue;
  auto kernel = stream_kernel_for<T, C>(kt);
  const int stages = stream_stages<T>(g, kt == 0);
  const size_t smem = stream_layout<T>(g, kt == 0, stages).total;
  if (smem > kStreamSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.n[2] + t2 - 1) / t2, (g.n[1] + g.t[1] - 1) / g.t[1],
                  (g.n[0] + g.t[0] - 1) / g.t[0]);
  kernel<<<grid, kThreads, smem, stream>>>(y, approx, out, g, src, groups, scale,
                                           stages);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the analysis
//
// The streamed analysis body, shared by nddwt_dec_level (nddwt_level.cu)
// and nddwt_lead_dec (nddwt_4d.cu): the synthesis's walk turned around. The
// launch is over the same 3-slot views, with the analysis's halo (K/2 - 1 in
// front, K/2 behind) and the taps as given (not reversed):
//
//   nddwt_dec_level 3D  (n0, n1, n2), halos on all three slots;
//   nddwt_dec_level 2D  (n0, 1, n1): slot 1 is the pass-through;
//   nddwt_lead_dec      (X, Y, Z*T): slot 2 is the pass-through; the groups
//                       are the lane bands (inputs one view's extent apart).
//
// Input group gi gives the G in-plane bands b of each plane (G = 4 in 3D, 2
// otherwise; b = s1 + 2 s2 in 3D, s2 in 2D, s1 in the lead stage), and each
// of those two output bands along slot 0:
//
//   d = ((s0 << bit0) | (s1 << bit1) | (s2 << bit2)) + 4 gi,
//
// written to approx_out for d == 0 and to big[band_off + d - 1] otherwise,
// soft-thresholded (shrink) by lam > 0 when d > 0.
//
// A CTA owns a (T1, T2) plane tile on slots 1 and 2 and a chunk of C
// outputs along slot 0, and walks the chunk's C + K0 - 1 input planes. Each
// plane's window is copied once, asynchronously (StreamCopy). Per plane the
// in-plane passes run depth first: the slot-2 lo and hi into Q, then the
// slot-1 lo and hi of each Q slice into registers (in 2D and the lead stage,
// the one in-plane pass straight from the window). The G results go into a
// ring of the last K0 planes along slot 0; once it is full, each output plane
// is lo/hi = sum_j tap0[s0][j] ring[j] (gather form: both s0 from one ring),
// written from registers as coalesced rows (plain stores: streaming,
// evict-first stores of the details were 5-18 % slower on an H100).
//
// Filter lengths 2, 4, 6, 8 on every slot with a halo (stream_unrolled) run
// with the tap loops unrolled and the ring in registers, KT x G x items words
// a thread, items (plane elements per thread: 4, 2 or 1, ana_items) as many
// as fit kAnaRingRegs registers at two CTAs per SM. Any other filters run
// with runtime tap loops, one element a thread and the ring in shared
// memory: K0 x gw x T1 T2 words, where gw (G, G/2 or G/4, from the plan) is
// the in-plane bands one walk of the chunk keeps; where the ring of all G
// does not fit, the chunk is walked G / gw times, one band group a walk,
// each walk copying its input planes again.
//
// What bounds it on an H100 (chip_ab_stages.py): at 256^3 db4 f32 a level
// moves 0.6 GB (0.18 ms at 3.35 TB/s) and takes about 0.52 ms; a build
// that skips the passes (and so the stores) takes 0.14 ms, one that skips
// the copies 0.30 ms: the passes and the stores of the 8 bands weigh most.
// The lead analysis at (128, 128, 128, 32) takes about 2.9 ms for a 1.6 ms
// bound, 1.3 ms of it the 16 band writes; there the copies-only (0.86 ms)
// and passes-only (2.02 ms) builds add up to the whole: the copies and the
// stores do not overlap. nddwt_dec_level's 3D views with filters of 2 to 8
// taps therefore run the analysis plane body instead (nddwt_plane.cuh:
// plane_ana_kernel); this body keeps the 2D levels, nddwt_lead_dec, runtime
// filter lengths and the multilevel kernels.

constexpr int kAnaRingRegs = 64;

template <typename C, int KT, int G>
__host__ __device__ constexpr int ana_items() {
  return KT == 0 ? 1
         : 4 * KT * G * (int)(sizeof(C) / 4) <= kAnaRingRegs ? 4
         : 2 * KT * G * (int)(sizeof(C) / 4) <= kAnaRingRegs ? 2
                                                             : 1;
}

template <typename C, int G>
__host__ __device__ int ana_items_for(int kt) {
  switch (kt) {
    case 2: return ana_items<C, 2, G>();
    case 4: return ana_items<C, 4, G>();
    case 6: return ana_items<C, 6, G>();
    case 8: return ana_items<C, 8, G>();
    default: return 1;
  }
}

// The lo and hi taps of one slot: in registers for KT > 0 (unrolled), read
// from shared memory in a runtime loop of K otherwise.
template <int KT, typename C>
struct Taps2 {
  C lo[KT > 0 ? KT : 1], hi[KT > 0 ? KT : 1];
  const C *plo, *phi;
  __device__ __forceinline__ explicit Taps2(C (*src)[kMaxTaps])
      : plo(src[0]), phi(src[1]) {
    if constexpr (KT > 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        lo[j] = plo[j];
        hi[j] = phi[j];
      }
    }
  }
  // a = sum_j lo[j] p[j stride], b = sum_j hi[j] p[j stride]: one read of p
  template <typename S>
  __device__ __forceinline__ void dot2(const S* p, int stride, int K, C& a,
                                       C& b) const {
    a = 0;
    b = 0;
    if constexpr (KT > 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const C v = to_f(p[j * stride]);
        a = mad(lo[j], v, a);
        b = mad(hi[j], v, b);
      }
    } else {
      for (int j = 0; j < K; ++j) {
        const C v = to_f(p[j * stride]);
        a = mad(plo[j], v, a);
        b = mad(phi[j], v, b);
      }
    }
  }
};

// The analysis of the unit at (o2, o1, p0), or of the CTA's block where
// o2 < 0; fold: the item strides of a folded view (FOLD only).
template <typename T, int KT, int G, bool FOLD, typename C>
__device__ void stream_ana(const T* __restrict__ x, T* __restrict__ big,
                           T* __restrict__ approx_out, const LevelT<C>& g,
                           int groups, int gw, long long band_off, C lam,
                           int stages, C (*taps)[2][kMaxTaps],
                           unsigned char* smem, int o2, int o1, int p0,
                           const Fold& fold) {
  constexpr int NI = ana_items<C, KT, G>();
  using Off = std::conditional_t<FOLD, long long, int>;  // an element's output offset
  constexpr int GR = KT > 0 ? G : 1;  // bands of the register ring
  const int nb = KT > 0 ? G : gw;     // bands a walk keeps
  const StreamLayout L = stream_layout<T>(g, KT == 0, stages, nb);
  long long* const row_off = reinterpret_cast<long long*>(smem);
  unsigned char* const wins = smem + L.rows;
  C* const Q = reinterpret_cast<C*>(wins + stages * L.win);
  C* const ring_s = reinterpret_cast<C*>(wins + stages * L.win + L.q);

  const int K0 = KT > 0 ? KT : g.k[0];
  const int K1 = g.k[1], K2 = g.k[2];
  const int T1 = g.t[1], T2 = g.t[2];
  const int lg2 = 31 - __clz(T2);
  const int tid = threadIdx.x;
  if (o2 < 0) {  // the level kernels' unit: their block's
    o2 = blockIdx.x * T2, o1 = blockIdx.y * T1, p0 = blockIdx.z * g.t[0];
  }
  const int w2 = min(T2, g.n[2] - o2), w1 = min(T1, g.n[1] - o1);
  const int cc = min(g.t[0], g.n[0] - p0);
  const int E1 = w1 + K1 - 1, E2 = w2 + K2 - 1;  // the window loaded
  const bool pad0 = g.pad[0];
  // Input row, plane and band strides, output band and plane strides; a
  // folded view's rows are items (each array's own stride, fold) and its bands
  // and planes an item's.
  const long long m2 = FOLD ? 1 : in_extent(g, 2);
  const long long plane_in = FOLD ? g.n[2] : (long long)in_extent(g, 1) * m2;
  const long long ivox = FOLD ? (long long)g.n[0] * g.n[2] : in_vox(g);
  const long long vox = FOLD ? ivox : (long long)g.n[0] * g.n[1] * g.n[2];
  const long long nplane = FOLD ? g.n[2] : (long long)g.n[1] * g.n[2];
  const int lgs1 = K1 > 1 ? 1 : 0;
  const int qs = (T1 + K1 - 1) * T2;  // one slice of Q
  const int walks = G / nb;
  const int R = cc + K0 - 1;  // input planes per walk
  const int nw = groups * walks * R;

  // A window's place in the walk: group, walk (band group), input plane.
  struct Pos {
    int gi, wk, r;
  };
  auto advance = [&](Pos& p) {
    if (++p.r == R) {
      p.r = 0;
      if (++p.wk == walks) {
        p.wk = 0;
        ++p.gi;
      }
    }
  };

  const StreamCopy<T, FOLD> cp = stream_copy<T, FOLD>(g, row_off, o1, o2, E1, E2, L.ws,
                                                      m2, g.pad[1], g.pad[2]);
  const int ws = L.ws, sh = cp.sh;
  auto issue = [&](int buf, const Pos& p) {
    const T* base = x + p.gi * ivox;
    const int pp = p0 - g.left[0] + p.r;
    const int g0 = pad0 ? pp + g.left[0] : wrap2(pp, g.n[0]);
    cp.issue(reinterpret_cast<T*>(wins + buf * L.win), base, base + g0 * plane_in, fold.src);
  };

  // This thread's plane elements: NI consecutive rows of column tid % T2 (a
  // plane of fewer than NI rows takes columns tid + kThreads i). Per
  // element: its place in an output plane (folded: in the bands, po, and in
  // the approximation, pa) and whether it is inside.
  int c1[NI], c2[NI];
  Off po[NI], pa[NI];  // pa: folded only
  unsigned inside = 0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (T1 >= NI) {
      c1[i] = (tid >> lg2) * NI + i;
      c2[i] = tid & (T2 - 1);
    } else {
      const int f = tid + kThreads * i;
      c1[i] = f >> lg2;
      c2[i] = f & (T2 - 1);
    }
    if constexpr (FOLD) {
      po[i] = (o1 + c1[i]) * fold.dst + o2 + c2[i];
      pa[i] = (o1 + c1[i]) * fold.adst + o2 + c2[i];
    } else {
      po[i] = (o1 + c1[i]) * g.n[2] + o2 + c2[i];  // a plane holds < 2^31
    }
    if (c1[i] < w1 && c2[i] < w2) inside |= 1u << i;
  }
  C ring[KT > 0 ? KT : 1][GR][NI];  // planes oldest first
#pragma unroll
  for (int m = 0; m < (KT > 0 ? KT : 1); ++m)
#pragma unroll
    for (int b = 0; b < GR; ++b)
#pragma unroll
      for (int i = 0; i < NI; ++i) ring[m][b][i] = 0;
  int newest = 0;  // the shared-memory ring's slot of the newest plane

  Pos ahead{0, 0, 0}, at{0, 0, 0};  // the window issued next, computed next
  int buf_ahead = 0, buf_at = 0;
  for (int w = 0; w < stages - 1; ++w) {
    if (w < nw) {
      issue(buf_ahead++, ahead);
      advance(ahead);
    }
    cp_commit();
  }
  for (int w = 0; w < nw; ++w, advance(at), buf_at = buf_at + 1 == stages ? 0 : buf_at + 1) {
    cp_wait(stages - 2);
    __syncthreads();  // window w has arrived; window w - 1 and Q are consumed
    if (w + stages - 1 < nw) {
      if (buf_ahead == stages) buf_ahead = 0;
      issue(buf_ahead++, ahead);
      advance(ahead);
    }
    cp_commit();

    const int gi = at.gi, r = at.r;
    const int b0 = KT > 0 ? 0 : at.wk * gw;  // the walk's first band
    const T* W = reinterpret_cast<const T*>(wins + buf_at * L.win);
    if constexpr (KT > 0) {  // the ring moves one plane on
#pragma unroll
      for (int m = 0; m < KT - 1; ++m)
#pragma unroll
        for (int b = 0; b < G; ++b)
#pragma unroll
          for (int i = 0; i < NI; ++i) ring[m][b][i] = ring[m + 1][b][i];
    } else {
      newest = r == 0 || newest + 1 == K0 ? 0 : newest + 1;
    }
    // The in-plane bands 2h (lo) and 2h + 1 (hi) of the last in-plane pass,
    // into the ring's newest plane (shared memory: the walk's bands only).
    C* const fresh = ring_s + newest * gw * (T1 * T2) + tid;
    if constexpr (G == 4) {
      // Slot 2 into the walk's slices of Q over the loaded rows, then slot 1.
      const int h0 = b0 >> 1, h1 = (b0 + nb - 1) >> 1;  // Q slice h: s2 = h
      const Taps2<KT, C> t2(taps[2]);
#pragma unroll 1
      for (int f = tid; f < E1 * T2; f += kThreads) {
        const int l1 = f >> lg2, c = f & (T2 - 1);
        C lo, hi;
        t2.dot2(W + l1 * ws + sh + c, 1, K2, lo, hi);
        if (h0 == 0) Q[f] = lo;
        if (h1 == 1) Q[(1 - h0) * qs + f] = hi;
      }
      __syncthreads();  // Q is complete
      const Taps2<KT, C> t1(taps[1]);
#pragma unroll
      for (int h = 0; h < G / 2; ++h) {
        if (KT == 0 && (h < h0 || h > h1)) continue;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          C lo, hi;
          t1.dot2(Q + (h - h0) * qs + c1[i] * T2 + c2[i], T2, K1, lo, hi);
          if constexpr (KT > 0) {
            ring[KT - 1][2 * h][i] = lo;
            ring[KT - 1][2 * h + 1][i] = hi;
          } else {
            if (2 * h >= b0) fresh[(2 * h - b0) * (T1 * T2)] = lo;
            if (2 * h + 1 < b0 + gw) fresh[(2 * h + 1 - b0) * (T1 * T2)] = hi;
          }
        }
      }
    } else {
      // One in-plane pass from the window: slot 2 in 2D (one row, or one row
      // an item where the batch is folded there), slot 1 in the lead stage
      // (slot 2 passes through).
      const bool twod = K1 == 1;
      const Taps2<KT, C> tp(taps[twod ? 2 : 1]);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        C lo, hi;
        if (twod)
          tp.dot2(W + (FOLD ? c1[i] * ws : 0) + sh + c2[i], 1, K2, lo, hi);
        else
          tp.dot2(W + c1[i] * ws + sh + c2[i], ws, K1, lo, hi);
        if constexpr (KT > 0) {
          ring[KT - 1][0][i] = lo;
          ring[KT - 1][1][i] = hi;
        } else {
          if (b0 == 0) fresh[0] = lo;
          if (b0 + gw == 2) fresh[(1 - b0) * (T1 * T2)] = hi;
        }
      }
    }
    if (r < K0 - 1) continue;

    // Output plane p0 + r - (K0 - 1): lo/hi along slot 0 over the ring, for
    // each band b of the walk.
    const long long q = (long long)(p0 + r - (K0 - 1)) * nplane;
    const Taps2<KT, C> t0(taps[0]);
    long long at_a = 0;  // folded: the element's place in the approximation
    auto emit = [&](int b, bool in, long long at_q, C lo, C hi) {
      if (!in) return;
      const int dlo = (((b & lgs1) << g.bit[1]) | ((b >> lgs1) << g.bit[2])) + 4 * gi;
      if (lam > 0) hi = shrink(hi, lam);
      big[(band_off + dlo) * vox + at_q] = from_f<T>(hi);  // d = dlo + 1
      if (dlo == 0) {
        approx_out[FOLD ? at_a : at_q] = from_f<T>(lo);
      } else {
        if (lam > 0) lo = shrink(lo, lam);
        big[(band_off + dlo - 1) * vox + at_q] = from_f<T>(lo);
      }
    };
    if constexpr (KT > 0) {
#pragma unroll
      for (int b = 0; b < G; ++b)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          C lo = 0, hi = 0;
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            lo = mad(t0.lo[j], ring[j][b][i], lo);
            hi = mad(t0.hi[j], ring[j][b][i], hi);
          }
          if constexpr (FOLD) at_a = q + pa[i];
          emit(b, inside >> i & 1, q + po[i], lo, hi);
        }
    } else {
      const int oldest = newest + 1 == K0 ? 0 : newest + 1;
      for (int b = b0; b < b0 + gw; ++b) {
        const C* e = ring_s + (b - b0) * (T1 * T2) + tid;
        C lo = 0, hi = 0;
        for (int j = 0, slot = oldest; j < K0; ++j, slot = slot + 1 == K0 ? 0 : slot + 1) {
          const C v = e[slot * gw * (T1 * T2)];
          lo = mad(t0.plo[j], v, lo);
          hi = mad(t0.phi[j], v, hi);
        }
        if constexpr (FOLD) at_a = q + pa[0];
        emit(b, inside & 1, q + po[0], lo, hi);
      }
    }
  }
}

template <typename T, int KT, int G, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    stream_ana_kernel(const T* __restrict__ x, T* __restrict__ big,
                      T* __restrict__ approx_out, const __grid_constant__ LevelT<C> g,
                      int groups, int gw, long long band_off, C lam, int stages) {
  __shared__ C taps[3][2][kMaxTaps];
  copy_taps(taps, g);
  stream_ana<T, KT, G, false>(x, big, approx_out, g, groups, gw, band_off, lam, stages,
                              taps, reinterpret_cast<unsigned char*>(shared_words<C>()),
                              -1, -1, -1, Fold{});
}

template <typename T, int G, typename C = compute_t<T>>
auto stream_ana_kernel_for(int kt) {
  switch (kt) {
    case 2: return stream_ana_kernel<T, 2, G, C>;
    case 4: return stream_ana_kernel<T, 4, G, C>;
    case 6: return stream_ana_kernel<T, 6, G, C>;
    case 8: return stream_ana_kernel<T, 8, G, C>;
    default: return stream_ana_kernel<T, 0, G, C>;
  }
}

// Launch one streamed analysis over the view g (t = (C, T1, T2)) with G
// in-plane bands, `groups` inputs one view's extent apart and gw bands a
// walk. Returns the cudaError_t of the launch.
template <typename T, int G, typename C = compute_t<T>>
int launch_stream_ana(const T* x, T* big, T* approx_out, const LevelT<C>& g,
                      int groups, int gw, long long band_off, C lam,
                      cudaStream_t stream) {
  const int kt = stream_unrolled(g.k);
  const int t2 = g.t[2];
  if (g.t[0] < 1 || g.t[1] < 1 || t2 < 1 || (t2 & (t2 - 1)) ||
      g.t[1] * t2 != kThreads * ana_items_for<C, G>(kt) || g.k[0] < 2 ||
      G != (g.k[1] > 1 ? 2 : 1) * (g.k[2] > 1 ? 2 : 1) || groups < 1 ||
      groups > 4 || gw < 1 || gw > G || G % gw || (kt > 0 && gw != G))
    return (int)cudaErrorInvalidValue;
  auto kernel = stream_ana_kernel_for<T, G, C>(kt);
  const int stages = stream_stages<T>(g, kt == 0, gw);
  const size_t smem = stream_layout<T>(g, kt == 0, stages, gw).total;
  if (smem > kStreamSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.n[2] + t2 - 1) / t2, (g.n[1] + g.t[1] - 1) / g.t[1],
                  (g.n[0] + g.t[0] - 1) / g.t[0]);
  kernel<<<grid, kThreads, smem, stream>>>(x, big, approx_out, g, groups, gw,
                                           band_off, lam, stages);
  return (int)cudaGetLastError();
}

}  // namespace
