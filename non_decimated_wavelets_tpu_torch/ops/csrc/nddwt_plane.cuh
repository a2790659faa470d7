// The plane body of nddwt_rec_level (nddwt_level.cu) on 3D views: the
// per-level synthesis where slots 1 and 2 both have a halo and every slot
// has the same filter length K of 2, 4, 6 or 8 (db1-db4). The analysis
// plane body of nddwt_dec_level on the same views, plane_ana_kernel, is at
// the end of this header.
//
// It replaces, for those views, the TPU kernel _make_rec_kernel /
// _fused_rec_level (non_decimated_wavelets_tpu/ops/pallas_kernels.py:1389,
// 1468), its float64 form _make_rec_kernel_df / _rec_level_df
// (pallas_df32.py:392,494) and the halo-padded ("valid") mode of
// _fused_rec_level (TPU kernel table row 23). Every other synthesis view
// (2D levels, nddwt_lead_adj, runtime filter lengths, the multilevel
// kernels) runs the window body stream_syn (nddwt_stream.cuh).
//
//   out = scale * sum_{s0, s1, s2} adj0_{s0} adj1_{s1} adj2_{s2} band(s0, s1, s2)
//
// with adj_a the K-tap correlation along slot a with the taps as given
// (already reversed), band index s0 << bit0 | s1 << bit1 | s2 << bit2.
//
// What bounds it on an H100: at knee3d's (320, 320, 256) db4 f32 a level
// moves 9 arrays of 26.2 M floats, 0.28 ms at 3.35 TB/s, and takes about 170
// FMAs an output in the window body's order (0.13 ms at 67 TFLOP/s). The
// window body took 1.96 ms there (14 % of the bytes bound) because its
// copies (cp.async by every thread, on the load/store path the passes use)
// did not overlap its passes, it waited at two CTA barriers per band window
// (16 a plane), and it filtered slot 2 first, over the wide slot-1 halo.
// This body takes about 0.49 ms there; a build without the passes takes
// as long, one without the copies 0.37-0.45 ms: it is bound by the bulk
// copies (about 1.7 GB from L2 a level, the halo rows of neighbouring tiles
// read again).
//
// What this design does about it:
//
// * Copies off the threads. A CTA owns a (T1, T2) tile on slots 1 and 2 and
//   a chunk of C outputs on slot 0, and walks the chunk's C + K - 1 input
//   planes. A stage is one (input plane, s0): the four (s1, s2) band windows
//   of E1 = w1 + K - 1 rows. Warp 0 copies a stage by cp.async.bulk,
//   completing on the stage buffer's mbarrier, `stages` buffers ahead; the
//   other warps wait on that mbarrier, not on a CTA barrier.
// * Few, large copies. Where the tile spans slot 2 (whole rows: T2 >= n2,
//   as at 256 columns) a window is E1 whole input rows, contiguous in memory
//   but for the periodic wrap of slot 1: one copy a run of rows, at most
//   three a window (a 15 KB copy at knee3d), and the slot-2 halo wraps
//   inside shared memory. Else every row's E2 = w2 + K - 1 columns are
//   copied in at most three pieces, split at the periodic wrap of slot 2,
//   each from the 16-byte boundary at or below its first column to the one
//   at or above its last (the neighbouring columns of the same row land in
//   the row's slack). Both take input rows that start on 16 bytes (the
//   slot-2 input extent a multiple of 16 bytes, every array 16-byte
//   aligned): then all rows share one shift, no piece or run leaves its
//   row, and a piece past the wrap lands where the one before it ends. Row
//   pieces are one copy a row or more: at (320, 320, 256) a tile of (8,
//   128) took 1.29 ms in pieces against 0.62 ms for (4, 256) in whole rows
//   (256 threads a CTA, on an H100).
// * One CTA barrier a stage, two a plane. Per stage: the slot-1 pass (every
//   thread), one __syncthreads (Q complete, the stage buffer free for the
//   copy `stages` ahead, which warp 0 then issues), the slot-2 pass and the
//   slot-0 ring. Q is double-buffered by stage parity, so the next stage's
//   slot-1 pass does not wait for this one's slot-2 readers.
// * Slot 1 before slot 2, both register-blocked. The slot-1 pass runs over
//   the window's columns (whole rows: the n2 columns of the row; Q columns
//   u < K - 1 are written again at u + n2, so the slot-2 pass reads past the
//   row's end unwrapped): an item is (s2, RW consecutive rows, a column); a
//   thread loads RW + K - 1 rows of the column from each of the two s1
//   windows into registers and sums both s1 into Q[s2] (the tree factoring
//   of the lane adjoint, nddwt_lane.cuh). Its halo amplification is E2 / T2
//   (1 in whole rows), not the window body's E1 / T1. The slot-2 pass then
//   gives each thread NI consecutive columns of one output row from vector
//   reads of NI + K - 1 values of each Q half. At K = 8 an output plane
//   costs about 112 FMAs an output against the window body's 168.
// * The slot-0 ring stays in registers (K x NI words a thread), as in the
//   window body; a finished output plane is stored NI elements at a time.
//
// The plan t = (C, T1, T2) is ops/cuda_kernels.py's _plane_plan: T1 * T2 =
// kPlaneThreads * NI, T2 a power of two, T1 a multiple of RW; the stages are
// the most of up to kPlaneMaxStages that fit. ops/stream_ref.py's
// plane_replay replays the schedule on the CPU.

#pragma once

#include <cstdint>

#include "nddwt_lane.cuh"

namespace {

// One CTA an SM of 16 warps (the registers of two CTAs of 256 threads at
// the same 128 a thread), whose tile has twice the rows, so fewer halo rows
// a plane: 0.49 against 0.53 ms at (320, 320, 256) db4 f32 on an H100.
constexpr int kPlaneThreads = 512;
constexpr int kPlaneMaxStages = 4;
constexpr int kPlaneRows = 4;    // RW: rows of one slot-1 item
constexpr int kPlaneRounds = 3;  // slot-1 items a thread, at most
// The dynamic shared memory a CTA may take (227 KB less its static taps
// and barriers).
constexpr size_t kPlaneSmem = 220 * 1024;
// The stage buffers start on 128 bytes, and so do the rows of a tile's
// columns: a build whose buffers began 16 bytes past a 64-byte boundary
// took 0.93 against 0.63 ms at (320, 320, 256) (256 threads, two stages)
// on an H100.
constexpr int kPlaneAlign = 128;

// NI: plane elements a thread (consecutive columns of one output row).
template <typename C>
__host__ __device__ constexpr int plane_items() {
  return sizeof(C) == 8 ? 2 : 4;
}

// N values in one aligned vector access.
template <typename S, int N>
struct alignas(N * sizeof(S)) PlaneVec {
  S v[N];
};

// Whole rows: the plane tile spans slot 2 (T2 >= n2, one column of tiles)
// and slot 2 is not halo-padded; a window is then E1 whole input rows.
template <typename C>
__host__ __device__ inline bool plane_whole(const LevelT<C>& g) {
  return !g.pad[2] && g.t[2] >= g.n[2];
}

// Shared memory of a launch, bytes: `stages` stage buffers of four windows
// (storage type T, T1 + K - 1 rows of ws elements: whole input rows, or the
// tile's E2 columns, shifted, in whole 128 bytes), then Q: two stage
// parities x two halves (s2) x T1 rows of qs compute words; and room to
// align the buffers.
struct PlaneLayout {
  int ws, qs;  // window and Q row strides, elements (whole 16 bytes at least)
  size_t win, stage, q, total;
};

template <typename T, typename C>
__host__ __device__ PlaneLayout plane_layout(const LevelT<C>& g, int stages) {
  constexpr int V = 16 / sizeof(T), VQ = 16 / sizeof(C), NI = plane_items<C>();
  const int K = g.k[2];
  PlaneLayout L;
  constexpr int A = kPlaneAlign / sizeof(T);  // a buffer row in whole 128 bytes
  L.ws = plane_whole(g) ? g.n[2] : (g.t[2] + K - 1 + V - 1 + A - 1) / A * A;
  // the last thread of a row reads from T2 - NI, NI + K - 1 values in vectors
  L.qs = g.t[2] - NI + (NI + K - 1 + VQ - 1) / VQ * VQ;
  L.win = (size_t)(g.t[1] + g.k[1] - 1) * L.ws * sizeof(T);
  L.stage = 4 * L.win;
  L.q = (size_t)4 * g.t[1] * L.qs * sizeof(C);
  L.total = kPlaneAlign + stages * L.stage + L.q;
  return L;
}

// The stages of a plan: the most (up to kPlaneMaxStages, at least 2) whose
// layout fits kPlaneSmem; 0 where two do not.
template <typename T, typename C>
__host__ __device__ int plane_stages(const LevelT<C>& g) {
  for (int s = kPlaneMaxStages; s >= 2; --s)
    if (plane_layout<T>(g, s).total <= kPlaneSmem) return s;
  return 0;
}

// Whether nddwt_rec_level's launch over g, reading y and approx, takes the
// plane body: both in-plane slots with a halo, one unrolled K on every
// slot, input rows on 16 bytes, and a plan of the plane body's form whose
// stages fit.
template <typename T, typename C>
bool plane_takes(const LevelT<C>& g, const void* y, const void* approx) {
  constexpr int V = 16 / sizeof(T), NI = plane_items<C>(), RW = kPlaneRows;
  const int K = g.k[0], T1 = g.t[1], T2 = g.t[2];
  if (!(K == 2 || K == 4 || K == 6 || K == 8) || g.k[1] != K || g.k[2] != K) return false;
  if (in_extent(g, 2) % V ||
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(approx)) & 15))
    return false;
  const int cols = plane_whole(g) ? g.n[2] : T2 + K - 1;  // slot-1 columns
  if (g.t[0] < 1 || T1 < RW || T1 % RW || T2 < NI || (T2 & (T2 - 1)) ||
      T1 * T2 != kPlaneThreads * NI || 2 * (T1 / RW) * cols > kPlaneRounds * kPlaneThreads)
    return false;
  return plane_stages<T>(g) > 0;
}

template <typename T, int KT, typename C = compute_t<T>>
__global__ void __launch_bounds__(kPlaneThreads, 1)
    plane_syn_kernel(const T* __restrict__ y, const T* __restrict__ approx,
                     T* __restrict__ out, const __grid_constant__ LevelT<C> g,
                     const __grid_constant__ StreamSources src, C scale, int stages) {
  constexpr int NI = plane_items<C>(), RW = kPlaneRows;
  constexpr int V = 16 / sizeof(T), VQ = 16 / sizeof(C);
  constexpr int NQ = (NI + KT - 1 + VQ - 1) / VQ;  // vectors a slot-2 row read
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ __align__(8) uint64_t bars[kPlaneMaxStages];
  copy_taps(taps, g);
  unsigned char* const raw = reinterpret_cast<unsigned char*>(shared_words<C>());
  unsigned char* const smem = raw + (-smem_addr(raw) & (kPlaneAlign - 1));
  const PlaneLayout L = plane_layout<T>(g, stages);
  T* const bufs = reinterpret_cast<T*>(smem);
  C* const Qs = reinterpret_cast<C*>(smem + stages * L.stage);
  const int ws = L.ws, qs = L.qs, winsz = (int)(L.win / sizeof(T));

  const int T1 = g.t[1], T2 = g.t[2], tid = threadIdx.x, lane = tid & 31;
  const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
  const int o2 = blockIdx.x * T2, o1 = blockIdx.y * T1, p0 = blockIdx.z * g.t[0];
  const int w2 = min(T2, n2 - o2), w1 = min(T1, n1 - o1), cc = min(g.t[0], n0 - p0);
  const int E1 = w1 + KT - 1, E2 = w2 + KT - 1;
  const bool pad0 = g.pad[0], pad1 = g.pad[1], pad2 = g.pad[2];
  const bool whole = plane_whole(g);
  const long long m2 = in_extent(g, 2);
  const long long plane_in = (long long)in_extent(g, 1) * m2;
  const long long ivox = in_vox(g);
  const long long nplane = (long long)n1 * n2;
  const int q0 = o1 - g.left[1];  // the input row of window row 0, unwrapped

  // The pieces of a window, the same in every window and plane, each
  // `pb` bytes from element pg of the input plane to element pd of the
  // window. Whole rows: runs of window rows whose input rows follow each
  // other (split at the periodic wrap of slot 1, none on a padded slot).
  // Else each row's columns c0 .. c0 + E2 - 1 split at the periodic wrap
  // of slot 2 (none on a padded slot), each from its first column rounded
  // down to 16 bytes to its end rounded up; pg is then the column, and the
  // row's input offset is added per row. sh: window column 0's element in a
  // buffer row (0 for whole rows).
  long long pg[3];
  int pd[3];
  unsigned pb[3];
  int np = 0, sh = 0;
  unsigned stage_bytes = 0;
  if (whole) {
    for (int l = 0; l < E1 && np < 3; ++np) {
      const int q = q0 + l;
      const int row = pad1 ? q + g.left[1] : wrap2(q, n1);
      const int len = pad1 ? E1 : min(E1 - l, n1 - row);
      pg[np] = (long long)row * m2;
      pd[np] = l * ws;
      pb[np] = (unsigned)(len * m2 * sizeof(T));
      stage_bytes += 4 * pb[np];
      l += len;
    }
  } else {
    for (int a = pad2 ? o2 : o2 - g.left[2], d = 0; d < E2 && np < 3; ++np) {
      const int col = pad2 ? a : wrap2(a, n2);
      const int len = pad2 ? E2 : min(E2 - d, n2 - col);
      const int lo = col & ~(V - 1), hi = (col + len + V - 1) & ~(V - 1);
      if (d == 0) sh = col - lo;
      pg[np] = lo;
      pd[np] = sh + d - (col - lo);
      pb[np] = (unsigned)((hi - lo) * sizeof(T));
      stage_bytes += 4u * E1 * pb[np];
      a += len;
      d += len;
    }
  }

  // Warp 0: expect stage s's bytes on buffer buf's barrier, then copy its
  // four windows, window w = 2 s1 + s2: whole rows one piece a lane, else
  // one row a lane.
  auto issue = [&](int s, int buf) {
    const int r = s >> 1, s0 = s & 1;
    const int pp = p0 - g.left[0] + r;
    const long long plane = (long long)(pad0 ? pp + g.left[0] : wrap2(pp, n0)) * plane_in;
    if (lane == 0) mbar_expect_tx(&bars[buf], stage_bytes);
    __syncwarp();
    T* const B = bufs + (size_t)buf * 4 * winsz;
    const int per = whole ? np : E1;  // copies (whole) or rows a window
    for (int f = lane; f < 4 * per; f += 32) {
      const int w = f / per, l = f - w * per;
      const long long id =
          src.idx[(s0 << g.bit[0]) | ((w >> 1) << g.bit[1]) | ((w & 1) << g.bit[2])];
      const T* const base = (id < 0 ? approx : y + id * ivox) + plane;
      T* const dst = B + w * winsz;
      if (whole) {
        bulk_copy(dst + pd[l], reinterpret_cast<uintptr_t>(base + pg[l]), pb[l], &bars[buf]);
      } else {
        const int q = q0 + l;
        const T* const row = base + (long long)(pad1 ? q + g.left[1] : wrap2(q, n1)) * m2;
        for (int p = 0; p < np; ++p)
          bulk_copy(dst + l * ws + pd[p], reinterpret_cast<uintptr_t>(row + pg[p]), pb[p],
                    &bars[buf]);
      }
    }
  };

  // This thread's slot-1 items (fixed for the CTA): item f = (s2, rows g RW
  // .., column u) of the 2 (T1 / RW) cols, its offset in window (0, s2) of a
  // stage buffer and in a Q buffer (-1: none). Whole rows: the n2 columns of
  // the row, Q column u from window column (u - left2) mod n2, and Q columns
  // u < K - 1 written again at u + n2 (qdup), so that the slot-2 pass reads
  // past the row's end without wrapping; else the E2 window columns.
  const int NG = T1 / RW, cols = whole ? n2 : E2, nitems = 2 * NG * cols;
  int woff[kPlaneRounds], qoff[kPlaneRounds];
  bool qdup[kPlaneRounds];
#pragma unroll
  for (int j = 0; j < kPlaneRounds; ++j) {
    const int f = tid + j * kPlaneThreads;
    woff[j] = qoff[j] = -1;
    qdup[j] = false;
    if (f < nitems) {
      const int u = f % cols, rest = f / cols, gq = rest % NG, s2 = rest / NG;
      woff[j] = s2 * winsz + gq * RW * ws + (whole ? wrap2(u - g.left[2], n2) : sh + u);
      qoff[j] = (s2 * T1 + gq * RW) * qs + u;
      qdup[j] = whole && u < KT - 1;
    }
  }
  // This thread's outputs: NI consecutive columns c of row l1 of the tile.
  const int tpr = T2 / NI;
  const int l1 = tid / tpr, c = (tid - l1 * tpr) * NI;
  const int nin = l1 < w1 ? max(0, min(NI, w2 - c)) : 0;
  const bool vec_out = nin == NI && n2 % NI == 0 &&
                       (reinterpret_cast<uintptr_t>(out) % (NI * sizeof(T))) == 0;
  const long long po = (long long)(o1 + l1) * n2 + o2 + c;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ns = 2 * (cc + KT - 1);  // stages of the walk: (input plane, s0)
  if (tid < 32)
    for (int s = 0; s < stages && s < ns; ++s) issue(s, s);

  C ring[KT][NI];
#pragma unroll
  for (int m = 0; m < KT; ++m)
#pragma unroll
    for (int i = 0; i < NI; ++i) ring[m][i] = 0;
  int buf = 0;
  unsigned phase = 0;
  for (int s = 0; s < ns; ++s) {
    const int r = s >> 1, s0 = s & 1;
    mbar_wait(&bars[buf], phase);
    const T* const B = bufs + (size_t)buf * 4 * winsz;
    C* const Q = Qs + (s & 1) * 2 * T1 * qs;
    // Slot 1: both s1 windows of each item's s2 into Q[s2].
#pragma unroll
    for (int j = 0; j < kPlaneRounds; ++j) {
      if (woff[j] < 0) continue;
      C acc[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) acc[i] = 0;
#pragma unroll
      for (int s1 = 0; s1 < 2; ++s1) {
        const Taps<KT, C> t1(taps[1][s1]);
        const T* p = B + 2 * s1 * winsz + woff[j];
        C v[RW + KT - 1];
#pragma unroll
        for (int m = 0; m < RW + KT - 1; ++m) v[m] = to_f(p[m * ws]);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int k = 0; k < KT; ++k) acc[i] = mad(t1.r[k], v[i + k], acc[i]);
      }
      C* const q = Q + qoff[j];
#pragma unroll
      for (int i = 0; i < RW; ++i) q[i * qs] = acc[i];
      if (qdup[j]) {
#pragma unroll
        for (int i = 0; i < RW; ++i) q[i * qs + n2] = acc[i];
      }
    }
    __syncthreads();  // Q is complete; every thread is done with buffer buf
    if (tid < 32 && s + stages < ns) issue(s + stages, buf);

    // Slot 2: NI columns from each Q half, then the slot-0 ring.
    C P[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) P[i] = 0;
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const Taps<KT, C> t2(taps[2][s2]);
      const PlaneVec<C, VQ>* q =
          reinterpret_cast<const PlaneVec<C, VQ>*>(Q + (s2 * T1 + l1) * qs + c);
      PlaneVec<C, VQ> v[NQ];
#pragma unroll
      for (int u = 0; u < NQ; ++u) v[u] = q[u];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int k = 0; k < KT; ++k)
          P[i] = mad(t2.r[k], v[(i + k) / VQ].v[(i + k) % VQ], P[i]);
    }
    const Taps<KT, C> t0(taps[0][s0]);
#pragma unroll
    for (int m = 0; m < KT; ++m)
#pragma unroll
      for (int i = 0; i < NI; ++i) ring[m][i] = mad(t0.rev(m, KT), P[i], ring[m][i]);
    if (s0 == 1) {
      // The ring's front is output plane p0 + r - (K - 1) of the chunk.
      if (r >= KT - 1 && nin > 0) {
        T* const dst = out + (long long)(p0 + r - (KT - 1)) * nplane + po;
        if (vec_out) {
          PlaneVec<T, NI> o;
#pragma unroll
          for (int i = 0; i < NI; ++i) o.v[i] = from_f<T>(ring[0][i] * scale);
          *reinterpret_cast<PlaneVec<T, NI>*>(dst) = o;
        } else {
#pragma unroll
          for (int i = 0; i < NI; ++i)
            if (i < nin) dst[i] = from_f<T>(ring[0][i] * scale);
        }
      }
#pragma unroll
      for (int m = 0; m < KT - 1; ++m)
#pragma unroll
        for (int i = 0; i < NI; ++i) ring[m][i] = ring[m + 1][i];
#pragma unroll
      for (int i = 0; i < NI; ++i) ring[KT - 1][i] = 0;
    }
    if (++buf == stages) {
      buf = 0;
      phase ^= 1u;
    }
  }
}

template <typename T, typename C = compute_t<T>>
auto plane_kernel_for(int kt) {
  switch (kt) {
    case 2: return plane_syn_kernel<T, 2, C>;
    case 4: return plane_syn_kernel<T, 4, C>;
    case 6: return plane_syn_kernel<T, 6, C>;
    default: return plane_syn_kernel<T, 8, C>;
  }
}

// Launch the plane body over the 3D view g (plane_takes holds). Returns the
// cudaError_t of the launch.
template <typename T, typename C = compute_t<T>>
int launch_plane(const T* y, const T* approx, T* out, const LevelT<C>& g,
                 const StreamSources& src, C scale, cudaStream_t stream) {
  auto kernel = plane_kernel_for<T, C>(g.k[0]);
  const int stages = plane_stages<T>(g);
  const size_t smem = plane_layout<T>(g, stages).total;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.n[2] + g.t[2] - 1) / g.t[2], (g.n[1] + g.t[1] - 1) / g.t[1],
                  (g.n[0] + g.t[0] - 1) / g.t[0]);
  kernel<<<grid, kPlaneThreads, smem, stream>>>(y, approx, out, g, src, scale, stages);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the analysis
//
// plane_ana_kernel: nddwt_dec_level on the same 3D views (one K of 2, 4, 6
// or 8 on every slot, input rows on 16 bytes), with the analysis's halo
// (K/2 - 1 in front, K/2 behind) and the taps as given. Band
// d = s0 << bit0 | s1 << bit1 | s2 << bit2 of output plane q is
//
//   sum_{j0, j1, j2} tap0[s0][j0] tap1[s1][j1] tap2[s2][j2] x[q + j0 - left0, ...]
//
// written to approx_out for d == 0 and to big[band_off + d - 1] otherwise,
// soft-thresholded by lam where SHRINK. It replaces, for those views, the
// TPU kernel _make_dec_kernel / _fused_dec_level (pallas_kernels.py:519,
// 776), its float64 form _make_dec_kernel_df / _dec_level_df
// (pallas_df32.py:271,334) and the halo-padded mode of _fused_dec_level
// (TPU kernel table rows 1, 18, 23). Every other analysis (2D levels,
// nddwt_lead_dec, runtime filter lengths, the multilevel kernels) runs the
// window body stream_ana (nddwt_stream.cuh).
//
// What bounds it on an H100: a level reads one array and writes eight, 943
// MB at knee3d's (320, 320, 256) f32, 839 MB of it the writes: 0.28 ms at
// 3.35 TB/s. The window body took 1.15 ms there, 1.93 with the shrink
// (whose division it pays per detail): its cp.async copies by every thread
// did not overlap its passes, and it filtered slot 2 over the slot-1 halo.
//
// The schedule is the synthesis's turned around. A CTA owns a (T1, T2) tile
// on slots 1 and 2 and a chunk of C outputs on slot 0 and walks the chunk's
// C + K - 1 input planes; a stage is one input plane's window of
// E1 = w1 + K - 1 rows, copied by warp 0 with cp.async.bulk `stages` ahead
// (whole rows where the tile spans slot 2: at most three copies, split at
// the periodic wrap of slot 1; else each row's columns in at most three
// pieces, as above). Per stage:
//
// * the slot-1 lo/hi pass over the window's columns (whole rows: the n2
//   columns of the row, Q columns u < K - 1 written again at u + n2), an
//   item being RA rows of one column from RA + K - 1 values, into Q[s1];
// * one __syncthreads (Q complete, the buffer free for the next copy);
// * the slot-2 pass: each half of the CTA takes one s1 (warp-uniform), a
//   thread NI consecutive columns of one row from vector reads of
//   NI + K - 1 values of Q[s1], both s2;
// * the slot-0 ring of the last K planes' two in-plane bands, in registers
//   (K x 2 x NI words: 64 at K = 8); once full, the 4 bands (s0, s2) of the
//   output plane are gathered over it and stored NI elements at a time
//   (16-byte stores in float32 and float64).
//
// Splitting the in-plane bands between the halves keeps the ring at 64
// registers with NI = 4 (the whole ring of a thread's four bands would take
// 128), so a plane tile is T1 x T2 = 256 NI outputs: 4 whole rows of 256
// in float32. The shrink sign(v) max(|v| - lam, 0) takes no division, and
// costs nothing measurable: at knee3d this body takes about 0.42 ms a
// level, 0.395 queued (71 % of the bytes bound), plain or with the shrink
// (H100). Its 240 CTAs run in two waves; a build that walked equal shares
// of the tiles' planes in one wave of 132 CTAs (a run of each tile a share
// crosses) took 0.475 ms: its extra state spilled registers. A build that
// unrolled the walk K stages at a time, so that no plane moves in the
// ring, took 0.46.
//
// The plan t = (C, T1, T2) is ops/cuda_kernels.py's _plane_ana_plan: T1 * T2
// = kPlaneThreads / 2 * NI, T2 a power of two, T1 a multiple of RA.
// ops/stream_ref.py's plane_ana_replay replays the schedule on the CPU.

constexpr int kPlaneAnaRows = 2;  // RA: rows of one slot-1 item

// The plane tile's outputs: kPlaneThreads / 2 threads of NI elements.
template <typename C>
__host__ __device__ constexpr int plane_ana_tile() {
  return kPlaneThreads / 2 * plane_items<C>();
}

// Shared memory of an analysis launch, bytes: `stages` stage buffers of one
// window (as plane_layout's), then Q: two stage parities x two halves (s1)
// x T1 rows of qs compute words; and room to align the buffers.
template <typename T, typename C>
__host__ __device__ PlaneLayout plane_ana_layout(const LevelT<C>& g, int stages) {
  PlaneLayout L = plane_layout<T>(g, stages);
  L.stage = L.win;
  L.total = kPlaneAlign + stages * L.stage + L.q;
  return L;
}

template <typename T, typename C>
__host__ __device__ int plane_ana_stages(const LevelT<C>& g) {
  for (int s = kPlaneMaxStages; s >= 2; --s)
    if (plane_ana_layout<T>(g, s).total <= kPlaneSmem) return s;
  return 0;
}

// Whether nddwt_dec_level's launch over g, reading x, takes the plane body:
// both in-plane slots with a halo, one unrolled K on every slot, input rows
// on 16 bytes, and a plan of the analysis's form whose stages fit.
template <typename T, typename C>
bool plane_ana_takes(const LevelT<C>& g, const void* x) {
  constexpr int V = 16 / sizeof(T), NI = plane_items<C>(), RA = kPlaneAnaRows;
  const int K = g.k[0], T1 = g.t[1], T2 = g.t[2];
  if (!(K == 2 || K == 4 || K == 6 || K == 8) || g.k[1] != K || g.k[2] != K) return false;
  if (in_extent(g, 2) % V || (reinterpret_cast<uintptr_t>(x) & 15)) return false;
  const int cols = plane_whole(g) ? g.n[2] : T2 + K - 1;  // slot-1 columns
  if (g.t[0] < 1 || T1 < RA || T1 % RA || T2 < NI || (T2 & (T2 - 1)) ||
      T1 * T2 != plane_ana_tile<C>() || (T1 / RA) * cols > kPlaneRounds * kPlaneThreads)
    return false;
  return plane_ana_stages<T>(g) > 0;
}

// sign(v) max(|v| - lam, 0), as m - min(m, lam): the soft threshold of
// shrink (nddwt_common.cuh) without its division, NaN kept.
__device__ __forceinline__ float shrink_nd(float v, float lam) {
  const float m = fabsf(v);
  return copysignf(m - fminf(m, lam), v);
}
__device__ __forceinline__ double shrink_nd(double v, double lam) {
  const double m = fabs(v);
  return copysign(m - fmin(m, lam), v);
}

template <typename T, int KT, bool SHRINK, typename C = compute_t<T>>
__global__ void __launch_bounds__(kPlaneThreads, 1)
    plane_ana_kernel(const T* __restrict__ x, T* __restrict__ big, T* __restrict__ approx_out,
                     const __grid_constant__ LevelT<C> g, long long band_off, C lam,
                     int stages) {
  constexpr int NI = plane_items<C>(), RA = kPlaneAnaRows, HT = kPlaneThreads / 2;
  constexpr int V = 16 / sizeof(T), VQ = 16 / sizeof(C);
  constexpr int NQ = (NI + KT - 1 + VQ - 1) / VQ;  // vectors a slot-2 row read
  __shared__ C taps[3][2][kMaxTaps];
  __shared__ __align__(8) uint64_t bars[kPlaneMaxStages];
  copy_taps(taps, g);
  unsigned char* const raw = reinterpret_cast<unsigned char*>(shared_words<C>());
  unsigned char* const smem = raw + (-smem_addr(raw) & (kPlaneAlign - 1));
  const PlaneLayout L = plane_ana_layout<T>(g, stages);
  T* const bufs = reinterpret_cast<T*>(smem);
  C* const Qs = reinterpret_cast<C*>(smem + stages * L.stage);
  const int ws = L.ws, qs = L.qs, winsz = (int)(L.win / sizeof(T));

  const int T1 = g.t[1], T2 = g.t[2], tid = threadIdx.x, lane = tid & 31;
  const int n0 = g.n[0], n1 = g.n[1], n2 = g.n[2];
  const int o2 = blockIdx.x * T2, o1 = blockIdx.y * T1, p0 = blockIdx.z * g.t[0];
  const int w2 = min(T2, n2 - o2), w1 = min(T1, n1 - o1), cc = min(g.t[0], n0 - p0);
  const int E1 = w1 + KT - 1, E2 = w2 + KT - 1;
  const bool pad0 = g.pad[0], pad1 = g.pad[1], pad2 = g.pad[2];
  const bool whole = plane_whole(g);
  const long long m2 = in_extent(g, 2);
  const long long plane_in = (long long)in_extent(g, 1) * m2;
  const long long nplane = (long long)n1 * n2;
  const long long vox = (long long)n0 * nplane;
  const int q0 = o1 - g.left[1];  // the input row of window row 0, unwrapped

  // The pieces of a window, as plane_syn_kernel's: whole rows, runs of
  // window rows whose input rows follow each other; else each row's
  // columns split at the periodic wrap of slot 2, on whole 16 bytes.
  long long pg[3];
  int pd[3];
  unsigned pb[3];
  int np = 0, sh = 0;
  unsigned stage_bytes = 0;
  if (whole) {
    for (int l = 0; l < E1 && np < 3; ++np) {
      const int q = q0 + l;
      const int row = pad1 ? q + g.left[1] : wrap2(q, n1);
      const int len = pad1 ? E1 : min(E1 - l, n1 - row);
      pg[np] = (long long)row * m2;
      pd[np] = l * ws;
      pb[np] = (unsigned)(len * m2 * sizeof(T));
      stage_bytes += pb[np];
      l += len;
    }
  } else {
    for (int a = pad2 ? o2 : o2 - g.left[2], d = 0; d < E2 && np < 3; ++np) {
      const int col = pad2 ? a : wrap2(a, n2);
      const int len = pad2 ? E2 : min(E2 - d, n2 - col);
      const int lo = col & ~(V - 1), hi = (col + len + V - 1) & ~(V - 1);
      if (d == 0) sh = col - lo;
      pg[np] = lo;
      pd[np] = sh + d - (col - lo);
      pb[np] = (unsigned)((hi - lo) * sizeof(T));
      stage_bytes += E1 * pb[np];
      a += len;
      d += len;
    }
  }

  // Warp 0: expect stage s's bytes (input plane s of the walk) on buffer
  // buf's barrier, then copy its window: whole rows one run a lane, else
  // one row a lane.
  auto issue = [&](int s, int buf) {
    const int pp = p0 - g.left[0] + s;
    const T* const base = x + (long long)(pad0 ? pp + g.left[0] : wrap2(pp, n0)) * plane_in;
    if (lane == 0) mbar_expect_tx(&bars[buf], stage_bytes);
    __syncwarp();
    T* const B = bufs + (size_t)buf * winsz;
    if (whole) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
        if (p < np && lane == p)
          bulk_copy(B + pd[p], reinterpret_cast<uintptr_t>(base + pg[p]), pb[p], &bars[buf]);
    } else {
      for (int l = lane; l < E1; l += 32) {
        const int q = q0 + l;
        const T* const row = base + (long long)(pad1 ? q + g.left[1] : wrap2(q, n1)) * m2;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p < np)
            bulk_copy(B + l * ws + pd[p], reinterpret_cast<uintptr_t>(row + pg[p]), pb[p],
                      &bars[buf]);
      }
    }
  };

  // This thread's slot-1 items (fixed for the CTA): item f = (rows g RA ..,
  // column u) of the T1 / RA cols, its offset in a stage buffer and in Q[0]
  // (-1: none). Whole rows: the n2 columns of the row, Q column u from
  // window column (u - left2) mod n2, written again at u + n2 for u < K - 1
  // (qdup); else the E2 window columns.
  const int cols = whole ? n2 : E2, nitems = (T1 / RA) * cols;
  int woff[kPlaneRounds], qoff[kPlaneRounds];
  bool qdup[kPlaneRounds];
#pragma unroll
  for (int j = 0; j < kPlaneRounds; ++j) {
    const int f = tid + j * kPlaneThreads;
    woff[j] = qoff[j] = -1;
    qdup[j] = false;
    if (f < nitems) {
      const int u = f % cols, gq = f / cols;
      woff[j] = gq * RA * ws + (whole ? wrap2(u - g.left[2], n2) : sh + u);
      qoff[j] = gq * RA * qs + u;
      qdup[j] = whole && u < KT - 1;
    }
  }
  // This thread's outputs: band s1 (the CTA's half), NI consecutive columns
  // c of row l1 of the tile; its bands d = s0 << bit0 | s1 << bit1 | s2 << bit2.
  const int s1 = tid / HT, h = tid - s1 * HT, tpr = T2 / NI;
  const int l1 = h / tpr, c = (h - l1 * tpr) * NI;
  const int nin = l1 < w1 ? max(0, min(NI, w2 - c)) : 0;
  const bool vec_out =
      nin == NI && n2 % NI == 0 &&
      ((reinterpret_cast<uintptr_t>(big) | reinterpret_cast<uintptr_t>(approx_out)) %
       (NI * sizeof(T))) == 0;
  const long long po = (long long)(o1 + l1) * n2 + o2 + c;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ns = cc + KT - 1;  // stages of the walk: its input planes
  if (tid < 32)
    for (int s = 0; s < stages && s < ns; ++s) issue(s, s);

  C ring[KT][2][NI];  // the last K planes' bands (s1, s2), oldest first
#pragma unroll
  for (int m = 0; m < KT; ++m)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < NI; ++i) ring[m][b][i] = 0;
  int buf = 0;
  unsigned phase = 0;
  for (int s = 0; s < ns; ++s) {
    mbar_wait(&bars[buf], phase);
    const T* const B = bufs + (size_t)buf * winsz;
    C* const Q = Qs + (s & 1) * 2 * T1 * qs;
    {  // Slot 1: lo into Q[0], hi into Q[1].
      const Taps2<KT, C> t1(taps[1]);
#pragma unroll
      for (int j = 0; j < kPlaneRounds; ++j) {
        if (woff[j] < 0) continue;
        const T* const p = B + woff[j];
        C v[RA + KT - 1];
#pragma unroll
        for (int m = 0; m < RA + KT - 1; ++m) v[m] = to_f(p[m * ws]);
        C* const q = Q + qoff[j];
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          C lo = 0, hi = 0;
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            lo = mad(t1.lo[k], v[i + k], lo);
            hi = mad(t1.hi[k], v[i + k], hi);
          }
          q[i * qs] = lo;
          q[(T1 + i) * qs] = hi;
          if (qdup[j]) {
            q[i * qs + n2] = lo;
            q[(T1 + i) * qs + n2] = hi;
          }
        }
      }
    }
    __syncthreads();  // Q is complete; every thread is done with buffer buf
    if (tid < 32 && s + stages < ns) issue(s + stages, buf);

    // Slot 2: NI columns of row l1 of Q[s1], both s2, into the ring.
#pragma unroll
    for (int m = 0; m < KT - 1; ++m)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < NI; ++i) ring[m][b][i] = ring[m + 1][b][i];
    {
      const Taps2<KT, C> t2(taps[2]);
      const PlaneVec<C, VQ>* const q =
          reinterpret_cast<const PlaneVec<C, VQ>*>(Q + (s1 * T1 + l1) * qs + c);
      PlaneVec<C, VQ> v[NQ];
#pragma unroll
      for (int u = 0; u < NQ; ++u) v[u] = q[u];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        C lo = 0, hi = 0;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const C w = v[(i + k) / VQ].v[(i + k) % VQ];
          lo = mad(t2.lo[k], w, lo);
          hi = mad(t2.hi[k], w, hi);
        }
        ring[KT - 1][0][i] = lo;
        ring[KT - 1][1][i] = hi;
      }
    }
    // The ring is full from input plane K - 1 on: output plane p0 + s - (K - 1).
    if (s >= KT - 1 && nin > 0) {
      const long long at = (long long)(p0 + s - (KT - 1)) * nplane + po;
      const Taps2<KT, C> t0(taps[0]);
#pragma unroll
      for (int s0 = 0; s0 < 2; ++s0)
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int d = (s0 << g.bit[0]) | (s1 << g.bit[1]) | (s2 << g.bit[2]);
          PlaneVec<T, NI> o;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            C v = 0;
#pragma unroll
            for (int j = 0; j < KT; ++j) v = mad(s0 ? t0.hi[j] : t0.lo[j], ring[j][s2][i], v);
            if (SHRINK && d > 0) v = shrink_nd(v, lam);
            o.v[i] = from_f<T>(v);
          }
          T* const dst = (d == 0 ? approx_out : big + (band_off + d - 1) * vox) + at;
          if (vec_out) {
            *reinterpret_cast<PlaneVec<T, NI>*>(dst) = o;
          } else {
#pragma unroll
            for (int i = 0; i < NI; ++i)
              if (i < nin) dst[i] = o.v[i];
          }
        }
    }
    if (++buf == stages) {
      buf = 0;
      phase ^= 1u;
    }
  }
}

template <typename T, bool SHRINK, typename C = compute_t<T>>
auto plane_ana_kernel_for(int kt) {
  switch (kt) {
    case 2: return plane_ana_kernel<T, 2, SHRINK, C>;
    case 4: return plane_ana_kernel<T, 4, SHRINK, C>;
    case 6: return plane_ana_kernel<T, 6, SHRINK, C>;
    default: return plane_ana_kernel<T, 8, SHRINK, C>;
  }
}

// Launch the analysis plane body over the 3D view g (plane_ana_takes
// holds), shrinking the details where lam > 0. Returns the cudaError_t of
// the launch.
template <typename T, typename C = compute_t<T>>
int launch_plane_ana(const T* x, T* big, T* approx_out, const LevelT<C>& g,
                     long long band_off, C lam, cudaStream_t stream) {
  auto kernel = lam > 0 ? plane_ana_kernel_for<T, true, C>(g.k[0])
                        : plane_ana_kernel_for<T, false, C>(g.k[0]);
  const int stages = plane_ana_stages<T>(g);
  const size_t smem = plane_ana_layout<T>(g, stages).total;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.n[2] + g.t[2] - 1) / g.t[2], (g.n[1] + g.t[1] - 1) / g.t[1],
                  (g.n[0] + g.t[0] - 1) / g.t[0]);
  kernel<<<grid, kPlaneThreads, smem, stream>>>(x, big, approx_out, g, band_off, lam, stages);
  return (int)cudaGetLastError();
}

}  // namespace
