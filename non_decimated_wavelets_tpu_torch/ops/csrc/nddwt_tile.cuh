// One output tile of a 2D or 3D level, analysis or synthesis: the bodies of
// the one-launch multilevel kernels (nddwt_multi.cu), which loop a
// persistent grid over the tiles of every batch item and level. (The
// per-level kernels stream instead: nddwt_stream.cuh.)
//
// A CTA loads the tile's halo'd input into shared memory once, wrapping
// every index periodically (so extents smaller than the halo work), and
// runs the separable K-tap passes there, axis 0 -> 2, depth first: a pass's
// lo and hi halves are computed one after the other, so only one
// intermediate per axis is live (the shape of the TPU kernels' band tree,
// _tree_expand / _tree_reduce).
//
// Loads go through L2 only (ld.global.cg): the multilevel kernels read in
// one level what other CTAs wrote in the level before, and the read-only
// and L1 caches are not coherent with those writes.
//
// Shared memory, in words of the compute type: the (e0, e1, e2) input tile,
// the (t0, e1, e2) and (t0, t1, e2) intermediates, and for the synthesis the
// (t0, t1, t2) output tile (tile_smem_bytes). Every tile function reads
// the taps from `taps` (shared, already copied) and leaves shared memory
// in use when it returns: the caller puts a __syncthreads() before the
// next tile.

#pragma once

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
    s[i] = to_f(__ldcg(src + (g0 * g.n[1] + g1) * g.n[2] + g2));
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

// Analysis of tile `tile`: writes detail band b (b >= 1) to
// big[band_off + b - 1] and band 0 to approx_out (the next approximation,
// or big[0] at the final level). lam > 0 soft-thresholds the details in
// registers.
template <typename T, typename C>
__device__ void dec_tile(const T* __restrict__ x, T* __restrict__ big,
                         T* __restrict__ approx_out, const LevelT<C>& g,
                         C (*taps)[2][kMaxTaps], C* smem, long long band_off,
                         C lam, unsigned int tile) {
  int b[3];
  tile_origin(g, tile, b);
  const int t0 = g.t[0], t1 = g.t[1], t2 = g.t[2];
  const int e0 = t0 + g.k[0] - 1, e1 = t1 + g.k[1] - 1, e2 = t2 + g.k[2] - 1;
  C* s0 = smem;               // (e0, e1, e2) input tile
  C* p1 = s0 + e0 * e1 * e2;  // (t0, e1, e2) after axis 0
  C* p2 = p1 + t0 * e1 * e2;  // (t0, t1, e2) after axis 1
  load_tile(s0, x, g, b[0] - g.left[0], b[1] - g.left[1],
                       b[2] - g.left[2], e0, e1, e2);
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

// Synthesis of tile `tile`: out = scale * sum_b adjoint_b(band b), band b
// read from y[src.idx[b]] or from approx. The taps arrive reversed, so the
// adjoint is the same forward correlation over a tile with the mirrored
// halo.
template <typename T, typename C>
__device__ void rec_tile(const T* __restrict__ y, const T* __restrict__ approx,
                         T* __restrict__ out, const LevelT<C>& g,
                         const Sources& src, C scale, C (*taps)[2][kMaxTaps],
                         C* smem, unsigned int tile) {
  int b[3];
  tile_origin(g, tile, b);
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

// Dynamic shared memory of one tile, in bytes.
template <typename C>
size_t tile_smem_bytes(const LevelT<C>& g, bool rec) {
  const size_t e0 = g.t[0] + g.k[0] - 1, e1 = g.t[1] + g.k[1] - 1,
               e2 = g.t[2] + g.k[2] - 1;
  size_t w = e0 * e1 * e2 + g.t[0] * e1 * e2 + (size_t)g.t[0] * g.t[1] * e2;
  if (rec) w += (size_t)g.t[0] * g.t[1] * g.t[2];
  return w * sizeof(C);
}

}  // namespace
