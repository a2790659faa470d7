// The lane body of nddwt_lane_dec and nddwt_lane_adj (nddwt_4d.cu): whole
// (Z, T) slabs in shared memory, fed by bulk asynchronous copies.
//
// The lane stage of a 4D level runs over the view (X*Y, Z, T) with halos on
// Z (slot 1) and T (slot 2); the 3D long-filter route's over (X*Y, Z, 1),
// with T a pass-through. One X*Y index's (Z, T) slab is contiguous in
// memory, and at the 4D workload (128 x 32 f32, 16 KB) it fits shared
// memory many times over. So a unit of work is R consecutive slabs (a
// contiguous block: the periodic halo on Z and T wraps inside shared
// memory, and each input is read from device memory once); where the
// slabs are too large, a unit is one slab's chunk of Zc outputs along Z
// and its window of Zc + K1 - 1 rows, at most two contiguous pieces split
// at the periodic wrap. The plan t = (R, Zc, stages): Zc >= Z marks whole
// slabs (ops/cuda_kernels.py: _lane_plan).
//
// Copies: persistent CTAs walk the units (unit c + i * gridDim.x), with a
// ring of `stages` unit buffers. One thread copies unit i + stages - 1
// while the CTA computes unit i: per input array and piece, one
// cp.async.bulk completing on the buffer's mbarrier. A bulk copy needs
// 16-byte-aligned addresses and a size in whole 16 bytes, so each piece is
// copied from the 16-byte boundary at or below its start to the one at or
// above its end (the bytes around it are the tensor's own, and land in the
// buffer's slack around the piece: a piece sits at its address's offset
// mod 16); only where that would leave the tensor, at its very first or
// last bytes, the ragged head or tail elements are loaded by plain loads
// when the unit is consumed. Nothing is read outside the tensor.
//
// Passes, consecutive threads on consecutive t (a thread keeps its column
// t, so every band store is a coalesced row):
//
//   analysis  the T pass once per window row, lo and hi from one read of
//             K2 values, into Q (2 halves); then the Z pass of both halves,
//             a thread taking NZ consecutive z of one column from a
//             register window of NZ + K1 - 1 rows, and writing the 4 lane
//             bands c = zbit + 2 tbit of each output (2 in 3D, from the
//             window itself);
//   adjoint   the tree factoring of the JAX kernel (pallas_4d.py:1003):
//             the four Z adjoints summed into two halves Q (s2 = tbit),
//             NZ z a thread from register windows of each band, then the
//             two T adjoints, times the scale (3D: the two Z adjoints, out
//             from registers). The taps arrive reversed with the mirrored
//             halo, so each adjoint is a forward correlation.
//
// Filter lengths 2, 4, 6, 8 (the same K on Z and, where it has a halo, T:
// lane_unrolled) run with the tap loops unrolled and NZ = 8 (4 in float64);
// any other filter with runtime tap loops and NZ = 1. Every index wraps
// periodically, so any extent >= K runs. Two CTAs per SM where the plan's
// shared memory allows it.
//
// A lane stage whose smallest unit (one row chunk of K1 rows of the whole
// T row, for every input array, in one stage) does not fit shared memory
// runs on the tile body (nddwt_4d.cu: the wrapper names that body).

#pragma once

#include <cstdint>

#include "nddwt_common.cuh"
#include "nddwt_stream.cuh"

namespace {

constexpr int kLaneMaxStages = 4;
constexpr int kLaneMaxIn = 4;  // input arrays of a unit: 1, or 4 lane bands

// z outputs a thread takes in the Z pass.
template <typename C, int KT>
__host__ __device__ constexpr int lane_items() {
  return KT == 0 ? 1 : (sizeof(C) == 8 ? 4 : 8);
}

// The unrolled filter length of a lane launch, or 0 (runtime loops).
__host__ __device__ inline int lane_unrolled(const int* k) {
  const int K = k[1];
  if (K != 2 && K != 4 && K != 6 && K != 8) return 0;
  return k[2] == 1 || k[2] == K ? K : 0;
}

struct LanePlan {
  int n0, Z, T, K1, K2, left1, left2;
  int R, Zc, stages;  // t = (R, Zc, stages)
  int Ew;             // window rows of a unit per slab
  int nch;            // chunks of Z per slab
  int units;
  bool whole;         // units of whole slabs
};

template <typename C>
__host__ __device__ inline LanePlan lane_plan(const LevelT<C>& g) {
  LanePlan p;
  p.n0 = g.n[0];
  p.Z = g.n[1];
  p.T = g.n[2];
  p.K1 = g.k[1];
  p.K2 = g.k[2];
  p.left1 = g.left[1];
  p.left2 = g.left[2];
  p.R = g.t[0];
  p.Zc = g.t[1];
  p.stages = g.t[2];
  p.whole = p.Zc >= p.Z;
  if (p.whole) p.R = p.R < 1 ? 1 : p.R;
  else p.R = 1;
  p.Ew = p.whole ? p.Z : p.Zc + p.K1 - 1;
  p.nch = p.whole ? 1 : (p.Z + p.Zc - 1) / p.Zc;
  p.units = p.whole ? (p.n0 + p.R - 1) / p.R : p.n0 * p.nch;
  return p;
}

// Storage elements of one input array's window in a unit buffer: the unit's
// elements, rounded to 16 bytes, and the slack the pieces' offsets take.
template <typename T>
__host__ __device__ inline long long lane_win(const LanePlan& p) {
  constexpr int V = 16 / sizeof(T);
  const long long e = (long long)p.R * p.Ew * p.T;
  return (e + V - 1) / V * V + 3 * V;
}

// Compute words of one half of Q: the T pass of every window row
// (analysis) or the Z adjoints of every output row (adjoint); none in 3D.
__host__ __device__ inline long long lane_q(const LanePlan& p, bool adj) {
  if (p.K2 == 1) return 0;
  return (long long)p.R * (adj ? (p.Zc < p.Z ? p.Zc : p.Z) : p.Ew) * p.T;
}

// Dynamic shared memory of a launch, bytes: `stages` unit buffers of nin
// windows, then the two halves of Q.
template <typename T, typename C>
__host__ __device__ inline size_t lane_smem(const LanePlan& p, int nin, bool adj) {
  return (size_t)p.stages * nin * lane_win<T>(p) * sizeof(T) +
         2 * (size_t)lane_q(p, adj) * sizeof(C);
}

struct LaneUnit {
  int s0, ru, z0, zc, ew;  // first slab, slabs, first z, z outputs, window rows a slab
};

__device__ __forceinline__ LaneUnit lane_unit(const LanePlan& p, int u) {
  LaneUnit w;
  if (p.whole) {
    w.s0 = u * p.R;
    w.ru = min(p.R, p.n0 - w.s0);
    w.z0 = 0;
    w.zc = p.Z;
    w.ew = p.Z;
  } else {
    w.s0 = u / p.nch;
    w.z0 = (u - w.s0 * p.nch) * p.Zc;
    w.zc = min(p.Zc, p.Z - w.z0);
    w.ru = 1;
    w.ew = w.zc + p.K1 - 1;
  }
  return w;
}

// A contiguous piece of one input array copied into its window: elements
// g .. g + n of the array, at element s of the window.
struct LanePiece {
  long long g;
  int n, s;
};

// The window's rows: row L (over the unit's slabs, L = r * ew + l) starts
// at element (L < na ? a : b) + L * T of the window.
struct LaneWin {
  int a, b, na;
  __device__ __forceinline__ int off(int L, int T) const {
    return (L < na ? a : b) + L * T;
  }
};

template <typename T>
__device__ __forceinline__ int align_shift(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// The pieces of unit w of the array at `base`: one in whole-slab units;
// in chunked units the window rows z0 - left1 .. z0 - left1 + ew - 1,
// wrapped, as rows zs .. (piece 0) and, past the wrap, 0 .. (piece 1).
template <typename T>
__device__ __forceinline__ int lane_pieces(const LanePlan& p, const LaneUnit& w,
                                           const T* base, LanePiece* pc, LaneWin& win) {
  constexpr int V = 16 / sizeof(T);
  const long long slab = (long long)w.s0 * p.Z * p.T;
  if (p.whole) {
    pc[0] = {slab, w.ru * p.Z * p.T, align_shift(base + slab)};
    win = {pc[0].s, pc[0].s, 0x7fffffff};
    return 1;
  }
  int zs = w.z0 - p.left1;
  if (zs < 0) zs += p.Z;
  const int na = min(p.Z - zs, w.ew);
  pc[0] = {slab + (long long)zs * p.T, na * p.T, align_shift(base + slab + (long long)zs * p.T)};
  win = {pc[0].s, pc[0].s, na};
  if (w.ew == na) return 1;
  const int start = (pc[0].s + pc[0].n + V - 1) / V * V;
  pc[1] = {slab, (w.ew - na) * p.T, start + align_shift(base + slab)};
  win.b = pc[1].s - na * p.T;
  return 2;
}

// The bytes [lo, hi) of a piece that its bulk copy takes: its start and
// end rounded out to 16 bytes, or in where rounding out would leave the
// tensor [tlo, thi). Elements [e_lo, e_hi) of the piece arrive in bulk; the
// rest are loaded by plain loads. hi <= lo: no bulk copy.
struct LaneBulk {
  uintptr_t lo, hi;
  int e_lo, e_hi;
};

template <typename T>
__device__ __forceinline__ LaneBulk lane_bulk(const T* src, int n, uintptr_t tlo,
                                              uintptr_t thi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), b = a + (uintptr_t)n * sizeof(T);
  LaneBulk r;
  r.lo = a & ~(uintptr_t)15;
  if (r.lo < tlo) r.lo += 16;
  r.hi = (b + 15) & ~(uintptr_t)15;
  if (r.hi > thi) r.hi -= 16;
  if (r.hi <= r.lo) {
    r.e_lo = r.e_hi = 0;
    return r;
  }
  r.e_lo = r.lo > a ? (int)((r.lo - a) / sizeof(T)) : 0;
  r.e_hi = r.hi < b ? (int)((r.hi - a) / sizeof(T)) : n;
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A copy that never
// lands would hang the card: after about 2^24 tries (seconds) the kernel
// traps instead, and the launch fails.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, uintptr_t src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// c mod n for -n <= c < 2n.
__device__ __forceinline__ int lane_wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// The shared state of one launch.
template <typename T, typename C>
struct LaneCtx {
  LanePlan p;
  const T* src;      // the input arrays, one view's extent apart
  int nin;           // input arrays of a unit
  long long vox;     // elements of one array
  uintptr_t tlo, thi;
  unsigned char* bufs;  // stages unit buffers
  long long wb;      // elements of one window
  C* Q;
  uint64_t* bars;

  __device__ __forceinline__ T* window(int buf, int i) const {
    return reinterpret_cast<T*>(bufs) + ((long long)buf * nin + i) * wb;
  }

  // One thread: expect unit u's bytes on its buffer's barrier, then copy.
  __device__ void issue(int u, int buf) const {
    const LaneUnit w = lane_unit(p, u);
    unsigned bytes = 0;
    LanePiece pc[2];
    LaneWin win;
    for (int i = 0; i < nin; ++i) {
      const T* base = src + i * vox;
      const int np = lane_pieces(p, w, base, pc, win);
      for (int j = 0; j < np; ++j) {
        const LaneBulk bk = lane_bulk(base + pc[j].g, pc[j].n, tlo, thi);
        if (bk.hi > bk.lo) bytes += (unsigned)(bk.hi - bk.lo);
      }
    }
    mbar_expect_tx(&bars[buf], bytes);
    for (int i = 0; i < nin; ++i) {
      const T* base = src + i * vox;
      T* W = window(buf, i);
      const int np = lane_pieces(p, w, base, pc, win);
      for (int j = 0; j < np; ++j) {
        const T* ps = base + pc[j].g;
        const LaneBulk bk = lane_bulk(ps, pc[j].n, tlo, thi);
        if (bk.hi > bk.lo)
          bulk_copy(reinterpret_cast<unsigned char*>(W + pc[j].s) -
                        (reinterpret_cast<uintptr_t>(ps) - bk.lo),
                    bk.lo, (unsigned)(bk.hi - bk.lo), &bars[buf]);
      }
    }
  }

  // Every thread: the unit's windows, and the ragged elements of its pieces
  // loaded by plain loads; returns whether there were any (the caller then
  // waits at a barrier).
  __device__ bool windows(int u, int buf, LaneWin* wins) const {
    const LaneUnit w = lane_unit(p, u);
    bool any = false;
    LanePiece pc[2];
    for (int i = 0; i < nin; ++i) {
      const T* base = src + i * vox;
      T* W = window(buf, i);
      const int np = lane_pieces(p, w, base, pc, wins[i]);
      for (int j = 0; j < np; ++j) {
        const T* ps = base + pc[j].g;
        const LaneBulk bk = lane_bulk(ps, pc[j].n, tlo, thi);
        if (bk.e_lo == 0 && bk.e_hi == pc[j].n) continue;
        any = true;
        for (int e = threadIdx.x; e < bk.e_lo; e += kThreads) W[pc[j].s + e] = ps[e];
        for (int e = bk.e_hi + threadIdx.x; e < pc[j].n; e += kThreads)
          W[pc[j].s + e] = ps[e];
      }
    }
    // The buffer's next bulk copy must not pass these stores.
    if (any) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    return any;
  }
};

// The window row of output z's first tap plus m: wrapped in whole-slab
// units (rows past the slab's outputs are clamped: their sums are never
// stored), clamped to the window in chunked ones.
__device__ __forceinline__ int lane_row(const LanePlan& p, int ew, int zm) {
  if (p.whole) {
    const int l = lane_wrap(zm - p.left1, p.Z);
    return l < p.Z ? l : p.Z - 1;
  }
  return zm < ew ? zm : ew - 1;
}

// Runtime taps: f(j0, j1, L) for the runs of taps j0 .. j1 - 1 whose
// window rows L, L + 1, ... are consecutive in one piece of the window
// (at most three: before the periodic wrap, between, after; in chunked
// units, before and after the first piece's end na), so that the tap loop
// steps a pointer instead of wrapping every row.
template <typename F>
__device__ __forceinline__ void lane_zruns(const LanePlan& p, int r, int z, int na, F f) {
  const int K = p.K1;
  if (p.whole) {
    const int l0 = z - p.left1;  // tap 0's row, in (-Z, Z)
    const int ja = min(K, max(0, -l0)), jb = min(K, max(ja, p.Z - l0));
    if (ja > 0) f(0, ja, r * p.Z + l0 + p.Z);
    if (jb > ja) f(ja, jb, r * p.Z + l0 + ja);
    if (K > jb) f(jb, K, r * p.Z + l0 + jb - p.Z);
  } else {
    const int ja = min(K, max(0, na - z));
    if (ja > 0) f(0, ja, z);
    if (K > ja) f(ja, K, z + ja);
  }
}

// The same along T: f(j0, j1, c) for the runs of taps whose columns c, c +
// 1, ... do not wrap.
template <typename F>
__device__ __forceinline__ void lane_truns(const LanePlan& p, int t, F f) {
  const int K = p.K2, c0 = t - p.left2;
  const int ja = min(K, max(0, -c0)), jb = min(K, max(ja, p.T - c0));
  if (ja > 0) f(0, ja, c0 + p.T);
  if (jb > ja) f(ja, jb, c0 + ja);
  if (K > jb) f(jb, K, c0 + jb - p.T);
}

// The Z pass of one column over NZ outputs from z (slab r): lo[i] and
// hi[i] = sum_j tap[j] row(z + i + j), `rowp(L)` pointing at window row L's
// element of the column (rows of one piece are T apart).
template <int KT, int NZ, typename C, typename Rowp>
__device__ __forceinline__ void lane_zpass(const LanePlan& p, const Taps2<KT, C>& tz, int ew,
                                           int r, int z, int na, Rowp rowp, C* lo, C* hi) {
  if constexpr (KT > 0) {
    C v[NZ + KT - 1];
#pragma unroll
    for (int m = 0; m < NZ + KT - 1; ++m)
      v[m] = to_f(*rowp(r * ew + lane_row(p, ew, z + m)));
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      C a = 0, b = 0;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        a = mad(tz.lo[j], v[i + j], a);
        b = mad(tz.hi[j], v[i + j], b);
      }
      lo[i] = a;
      hi[i] = b;
    }
  } else {  // even and odd taps in separate sums (5 % faster at db20 on an H100)
    C a0 = 0, b0 = 0, a1 = 0, b1 = 0;
    lane_zruns(p, r, z, na, [&](int j0, int j1, int L) {
      auto q = rowp(L);
      int j = j0;
      for (; j + 1 < j1; j += 2, q += 2 * p.T) {
        const C v0 = to_f(q[0]), v1 = to_f(q[p.T]);
        a0 = mad(tz.plo[j], v0, a0);
        b0 = mad(tz.phi[j], v0, b0);
        a1 = mad(tz.plo[j + 1], v1, a1);
        b1 = mad(tz.phi[j + 1], v1, b1);
      }
      if (j < j1) {
        const C v = to_f(*q);
        a0 = mad(tz.plo[j], v, a0);
        b0 = mad(tz.phi[j], v, b0);
      }
    });
    lo[0] = a0 + a1;
    hi[0] = b0 + b1;
  }
}

// The Z adjoint of one column over NZ outputs from z: acc[i] += sum_j tp[j]
// row(z + i + j). (Computing the rows' offsets once per block for all four
// bands, instead of per band, was slower on an H100: 1.09 against 0.92 ms
// at (128, 128, 128, 32) db4.)
template <int KT, int NZ, typename C, typename Rowp>
__device__ __forceinline__ void lane_zacc(const LanePlan& p, const Taps<KT, C>& tp, int ew,
                                          int r, int z, int na, Rowp rowp, C* acc) {
  if constexpr (KT > 0) {
    C v[NZ + KT - 1];
#pragma unroll
    for (int m = 0; m < NZ + KT - 1; ++m)
      v[m] = to_f(*rowp(r * ew + lane_row(p, ew, z + m)));
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) acc[i] = mad(tp.r[j], v[i + j], acc[i]);
  } else {  // one sum (even and odd taps apart: 9 % slower at db20 on an H100)
    C a = acc[0];
    lane_zruns(p, r, z, na, [&](int j0, int j1, int L) {
      auto q = rowp(L);
      for (int j = j0; j < j1; ++j, q += p.T) a = mad(tp.s[j], to_f(*q), a);
    });
    acc[0] = a;
  }
}

// The T adjoint of one column: acc += sum_j tp[j] row[toff[j]] (runtime
// taps: the runs of lane_truns).
template <int KT, typename C, typename S>
__device__ __forceinline__ void lane_tacc(const LanePlan& p, const Taps<KT, C>& tp, int t,
                                          const int* toff, const S* row, C& acc) {
  if constexpr (KT > 0) {
#pragma unroll
    for (int j = 0; j < KT; ++j) acc = mad(tp.r[j], to_f(row[toff[j]]), acc);
  } else {
    lane_truns(p, t, [&](int j0, int j1, int c) {
      for (int j = j0; j < j1; ++j, ++c) acc = mad(tp.s[j], to_f(row[c]), acc);
    });
  }
}

// The T pass of one column: lo and hi = sum_j tp[j] row[toff[j]] from one
// read of each value. (Four rows a thread at once, as independent sums,
// changed the time by 1 % or less on an H100.)
template <int KT, typename C, typename S>
__device__ __forceinline__ void lane_tpass(const LanePlan& p, const Taps2<KT, C>& tt, int t,
                                           const int* toff, const S* row, C& lo, C& hi) {
  lo = 0;
  hi = 0;
  if constexpr (KT > 0) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const C v = to_f(row[toff[j]]);
      lo = mad(tt.lo[j], v, lo);
      hi = mad(tt.hi[j], v, hi);
    }
  } else {
    lane_truns(p, t, [&](int j0, int j1, int c) {
      for (int j = j0; j < j1; ++j, ++c) {
        const C v = to_f(row[c]);
        lo = mad(tt.plo[j], v, lo);
        hi = mad(tt.phi[j], v, hi);
      }
    });
  }
}

// The columns of a thread: t = tx, tx + TX, ... (TX = T up to kThreads),
// its rows ty, ty + TY, ... The kThreads - TX * TY threads left over get a
// row past every unit: they run the same code to the same barriers (a
// barrier that a warp's threads reach on different paths hangs), with
// nothing to do.
struct LaneThreads {
  int TX, TY, tx, ty;
  __device__ explicit LaneThreads(int T) {
    TX = T < kThreads ? T : kThreads;
    TY = kThreads / TX;
    ty = threadIdx.x / TX;
    tx = threadIdx.x - ty * TX;
    if (ty >= TY) ty = 1 << 24;
  }
};

// The walk of one launch: the ring of unit buffers and the passes of each
// unit, `pass` (the analysis or the adjoint) called per unit.
template <typename T, typename C, typename Pass>
__device__ void lane_walk(const LaneCtx<T, C>& cx, Pass pass) {
  const LanePlan& p = cx.p;
  const int c = blockIdx.x, G = gridDim.x;
  const int nloc = c < p.units ? (p.units - c + G - 1) / G : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&cx.bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < p.stages - 1 && k < nloc; ++k) cx.issue(c + k * G, k);
  LaneWin wins[kLaneMaxIn];
  for (int k = 0; k < nloc; ++k) {
    __syncthreads();  // unit k - 1 is consumed: its buffer and Q are free
    const int ahead = k + p.stages - 1;
    if (threadIdx.x == 0 && ahead < nloc) cx.issue(c + ahead * G, ahead % p.stages);
    const int buf = k % p.stages;
    mbar_wait(&cx.bars[buf], (unsigned)(k / p.stages) & 1u);
    if (cx.windows(c + k * G, buf, wins)) __syncthreads();
    pass(lane_unit(p, c + k * G), buf, wins);
  }
}

// Lane analysis: x (X*Y, Z, T) -> temp (nl, X*Y, Z, T), band zbit + 2 tbit.
template <typename T, int KT, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    lane_body_dec_kernel(const T* __restrict__ x, T* __restrict__ temp,
                         const __grid_constant__ LevelT<C> g) {
  constexpr int NZ = lane_items<C, KT>();
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ __align__(8) uint64_t bars[kLaneMaxStages];
  copy_taps(taps, g);
  unsigned char* smem = reinterpret_cast<unsigned char*>(shared_words<C>());
  LaneCtx<T, C> cx;
  cx.p = lane_plan(g);
  const LanePlan& p = cx.p;
  cx.src = x;
  cx.nin = 1;
  cx.vox = (long long)p.n0 * p.Z * p.T;
  cx.tlo = reinterpret_cast<uintptr_t>(x);
  cx.thi = cx.tlo + (uintptr_t)cx.vox * sizeof(T);
  cx.bufs = smem;
  cx.wb = lane_win<T>(p);
  cx.Q = reinterpret_cast<C*>(smem + (size_t)p.stages * cx.wb * sizeof(T));
  cx.bars = bars;
  const int qh = (int)lane_q(p, false);
  const LaneThreads th(p.T);
  const long long vox = cx.vox;
  C* const Q = cx.Q;

  lane_walk(cx, [&](const LaneUnit& w, int buf, const LaneWin* wins) {
    const T* W = cx.window(buf, 0);
    const LaneWin win = wins[0];
    const int rows = w.ru * w.ew;
    if (p.K2 > 1) {  // the T pass of every window row into Q
      const Taps2<KT, C> tt(taps[2]);
      for (int t = th.tx; t < p.T; t += th.TX) {
        int toff[KT > 0 ? KT : 1];
        if constexpr (KT > 0) {
#pragma unroll
          for (int j = 0; j < KT; ++j) toff[j] = lane_wrap(t - p.left2 + j, p.T);
        }
        for (int L = th.ty; L < rows; L += th.TY) {
          C lo, hi;
          lane_tpass<KT>(p, tt, t, toff, W + win.off(L, p.T), lo, hi);
          Q[L * p.T + t] = lo;
          Q[qh + L * p.T + t] = hi;
        }
      }
      __syncthreads();
    }
    // The Z pass of each half, NZ outputs a thread.
    const Taps2<KT, C> tz(taps[1]);
    const int nzb = (w.zc + NZ - 1) / NZ;
    const int dq = th.TY / nzb, dr = th.TY - dq * nzb;
    const int halves = p.K2 > 1 ? 2 : 1;
    for (int t = th.tx; t < p.T; t += th.TX) {
      int r = th.ty / nzb, zb = th.ty - r * nzb;
      while (r < w.ru) {
        const int z = zb * NZ;
        T* dst = temp + ((long long)w.s0 * p.Z + w.z0 + (long long)r * p.Z + z) * p.T + t;
        for (int h = 0; h < halves; ++h) {
          C lo[NZ], hi[NZ];
          if (p.K2 > 1) {
            const C* Qh = Q + h * qh + t;
            lane_zpass<KT, NZ>(p, tz, w.ew, r, z, win.na,
                               [&](int L) { return Qh + L * p.T; }, lo, hi);
          } else {
            lane_zpass<KT, NZ>(p, tz, w.ew, r, z, win.na,
                               [&](int L) { return W + win.off(L, p.T) + t; }, lo, hi);
          }
#pragma unroll
          for (int i = 0; i < NZ; ++i) {
            if (z + i >= w.zc) break;
            dst[(2 * h) * vox + (long long)i * p.T] = from_f<T>(lo[i]);
            dst[(2 * h + 1) * vox + (long long)i * p.T] = from_f<T>(hi[i]);
          }
        }
        zb += dr;
        r += dq;
        if (zb >= nzb) {
          zb -= nzb;
          ++r;
        }
      }
    }
  });
}

// Lane adjoint: partial (nl, X*Y, Z, T) -> scale * (X*Y, Z, T).
template <typename T, int KT, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads, 2)
    lane_body_adj_kernel(const T* __restrict__ partial, T* __restrict__ out,
                         const __grid_constant__ LevelT<C> g, C scale) {
  constexpr int NZ = lane_items<C, KT>();
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ __align__(8) uint64_t bars[kLaneMaxStages];
  copy_taps(taps, g);
  unsigned char* smem = reinterpret_cast<unsigned char*>(shared_words<C>());
  LaneCtx<T, C> cx;
  cx.p = lane_plan(g);
  const LanePlan& p = cx.p;
  const int halves = p.K2 > 1 ? 2 : 1;
  cx.src = partial;
  cx.nin = 2 * halves;
  cx.vox = (long long)p.n0 * p.Z * p.T;
  cx.tlo = reinterpret_cast<uintptr_t>(partial);
  cx.thi = cx.tlo + (uintptr_t)(cx.nin * cx.vox) * sizeof(T);
  cx.bufs = smem;
  cx.wb = lane_win<T>(p);
  cx.Q = reinterpret_cast<C*>(smem + (size_t)p.stages * cx.nin * cx.wb * sizeof(T));
  cx.bars = bars;
  const int qa = (int)lane_q(p, true);
  const LaneThreads th(p.T);
  C* const Q = cx.Q;

  lane_walk(cx, [&](const LaneUnit& w, int buf, const LaneWin* wins) {
    // The Z adjoints: half s2 sums bands s1 + 2 s2, NZ outputs a thread.
    const Taps<KT, C> tz0(taps[1][0]), tz1(taps[1][1]);
    const int nzb = (w.zc + NZ - 1) / NZ;
    const int dq = th.TY / nzb, dr = th.TY - dq * nzb;
    for (int t = th.tx; t < p.T; t += th.TX) {
      int r = th.ty / nzb, zb = th.ty - r * nzb;
      while (r < w.ru) {
        const int z = zb * NZ;
        for (int s2 = 0; s2 < halves; ++s2) {
          C acc[NZ];
#pragma unroll
          for (int i = 0; i < NZ; ++i) acc[i] = 0;
          const T* W0 = cx.window(buf, 2 * s2) + t;
          const T* W1 = cx.window(buf, 2 * s2 + 1) + t;
          const LaneWin win0 = wins[2 * s2], win1 = wins[2 * s2 + 1];
          lane_zacc<KT, NZ>(p, tz0, w.ew, r, z, win0.na,
                            [&](int L) { return W0 + win0.off(L, p.T); }, acc);
          lane_zacc<KT, NZ>(p, tz1, w.ew, r, z, win1.na,
                            [&](int L) { return W1 + win1.off(L, p.T); }, acc);
#pragma unroll
          for (int i = 0; i < NZ; ++i) {
            if (z + i >= w.zc) break;
            const int row = r * w.zc + z + i;
            if (p.K2 > 1)
              Q[s2 * qa + row * p.T + t] = acc[i];
            else
              out[((long long)w.s0 * p.Z + w.z0 + row) * p.T + t] = from_f<T>(acc[i] * scale);
          }
        }
        zb += dr;
        r += dq;
        if (zb >= nzb) {
          zb -= nzb;
          ++r;
        }
      }
    }
    if (p.K2 == 1) return;
    __syncthreads();  // Q is complete
    // The T adjoints of both halves, times the scale.
    const Taps<KT, C> tt0(taps[2][0]), tt1(taps[2][1]);
    const int rows = w.ru * w.zc;
    for (int t = th.tx; t < p.T; t += th.TX) {
      int toff[KT > 0 ? KT : 1];
      if constexpr (KT > 0) {
#pragma unroll
        for (int j = 0; j < KT; ++j) toff[j] = lane_wrap(t - p.left2 + j, p.T);
      }
      for (int L = th.ty; L < rows; L += th.TY) {
        const C* q0 = Q + L * p.T;
        C acc = 0;
        lane_tacc<KT>(p, tt0, t, toff, q0, acc);
        lane_tacc<KT>(p, tt1, t, toff, q0 + qa, acc);
        out[((long long)w.s0 * p.Z + w.z0 + L) * p.T + t] = from_f<T>(acc * scale);
      }
    }
  });
}

}  // namespace
