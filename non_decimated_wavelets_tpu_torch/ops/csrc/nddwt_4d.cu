// The two stages of one 4D level of the multilevel non-decimated DWT,
// hand-written for Hopper.
//
//   nddwt_lane_dec  replaces _lane_dec_call
//                   (non_decimated_wavelets_tpu/ops/pallas_4d.py:503)
//   nddwt_lead_dec  replaces _lead_dec_call (pallas_4d.py:592)
//   nddwt_lead_adj  replaces _lead_adj_call (pallas_4d.py:882)
//   nddwt_lane_adj  replaces _lane_adj_call (pallas_4d.py:998)
//
// An analysis level of an (X, Y, Z, T) array is the lane stage, K-tap lo/hi
// correlations along Z and T into 4 (z,t)-bands c = zbit + 2 tbit, then the
// lead stage, correlations of each along X and Y into the 16 bands
// b = xbit + 2 ybit + 4 c: 15 details written in place into the (B, ...)
// band array at band_off (soft-thresholded when lam > 0) and the next
// approximation, or band 0 at the final level. The synthesis runs the
// adjoints in reverse order: the lead stage sums the adjoints of bands 4c+a
// into partial c, the lane stage the adjoints of the 4 partials, times the
// per-level scale. Storage is float or bfloat16 (the 4 intermediate bands
// too, as on the TPU), every sum taken in float32 with float32 taps; or
// double, every sum in float64 with float64 taps (the TPU sends float64 4D
// levels to its XLA direct path, which has no kernel).
//
// Each stage is a launch over a 3-slot view of the array with a halo on two
// slots and one pass-through slot: the lane stage sees (X*Y, Z, T), the lead
// stage (X, Y, Z*T). A 3D array whose filters are too long for the
// per-level kernels (nddwt_level.cu keeps a halo on all three axes) runs
// through the same two stages as (X*Y, Z, 1) and (X, Y, Z), 2 lane bands
// and 8 bands in all: the pass-through slot has one tap of 1.0.
//
// What bounds them: device-memory bytes. At (128, 128, 128, 32) float32 one
// array is 268 MB; the lane analysis moves 5 arrays (0.40 ms at 3.35 TB/s),
// the lead analysis 20 (1.60 ms), the lead adjoint 20 and the lane adjoint
// 5. A halo on two slots instead of four keeps a CTA's window small (one
// launch per level with halos on all four axes does not fit 100 KB at db4,
// and reads its input 25 times).
//
// The lane stages run the lane body (nddwt_lane.cuh): persistent CTAs walk
// units of whole (Z, T) slabs (or, where slabs are too large, chunks of Z
// with their halo rows), each copied once into a ring of unit buffers by
// bulk asynchronous copies (cp.async.bulk on an mbarrier), the periodic
// halo wrapped inside shared memory. Every index wraps periodically, so any
// extent >= K runs: odd Z and T, T > 128.
//
// A lane stage whose smallest unit does not fit shared memory (a T row too
// long for K rows of every input array: for the adjoint T beyond 1504 at
// db4 in float32, beyond 167 at db38 in float32) runs on the tile body
// below instead (ops/cuda_kernels.py: _lane_plan finds no plan): a CTA
// loads a tile's halo'd window and runs the two K-tap passes there, flat
// indices split by multiply-high. The wrapper names the body (body 1). At
// db38 in float64 no tile fits that body's 32 KB either, and the wrapper
// raises (the adjoint beyond T = 83, the analysis beyond 112).
//
// The lead stages stream X instead (nddwt_stream.cuh over the (X, Y, Z*T)
// view, slot 2 the pass-through): a CTA owns (T1 rows of Y) x (T2 of Z*T)
// and a chunk of X, and copies each input plane's (T1 + K - 1) x T2 window,
// whose rows are contiguous along Z*T, asynchronously in 16-byte pieces.
// The adjoint runs the Y pass of each band's window and scatters along X
// into a ring of K partial planes per output group; the analysis runs the
// Y lo and hi of each lane band's window and gathers along X from a ring of
// the last K planes, writing 4 bands per lane band and output plane. Each
// plane of X is read once per chunk plus K - 1.
//
// The halo-padded ("valid") mode of the lead stage: nddwt_lead_dec and
// nddwt_lead_adj take a `pad` flag on slots 0 and 1 (X and Y of the
// (X, Y, Z*T) view). A padded slot's input is one rank's block of an axis
// sharded across ranks with its ring neighbours' rows around it (K/2 - 1 in
// front and K/2 behind for the analysis, K/2 and K/2 - 1 for the adjoint),
// read without wrapping; the outputs keep the block's extent. It computes
// what the TPU lead stage's concat and slab "valid" modes compute (TPU
// kernel table row 23): _lead_dec_call and _lead_adj_call with
// shape_xy=/padded= or slab_axes=/slabs= (pallas_4d.py:592,882) and the lane
// stage's emitted edges (_lane_edge_copies, pallas_4d.py:432), called by
// non_decimated_wavelets_tpu/parallel/sharded.py:440,512. The lane stages
// stay local: Z and T are never sharded. Both lead stages read a padded slot
// at position + left (nddwt_stream.cuh).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (ops/cuda_kernels.py does this at first use).

#include "nddwt_common.cuh"
#include "nddwt_lane.cuh"
#include "nddwt_stream.cuh"

namespace {

constexpr int kMaxBands = 16;

struct Sources {
  long long idx[kMaxBands];  // band d's index into y; -1 reads the approx array
};

// A flat index over (., n1, n2), slot 2 fastest, split into (c0, c1, c2)
// without a hardware division (FastDiv, nddwt_common.cuh): the index loops
// below would otherwise spend most of their instructions on it.
struct Split3 {
  FastDiv f1, f2;
  __device__ Split3(int n1, int n2) : f1(make_div(n1)), f2(make_div(n2)) {}
  __device__ __forceinline__ void operator()(int i, int& c0, int& c1,
                                             int& c2) const {
    const int r = fdiv(f2, i);
    c2 = i - r * (int)f2.d;
    c0 = fdiv(f1, r);
    c1 = r - c0 * (int)f1.d;
  }
};

// i mod n for -n <= i < 3n: the wrapper keeps every tile inside its extent
// and every filter no longer than an axis, so window indices stay there.
__device__ __forceinline__ int wrap3(int i, int n) {
  if (i < 0) return i + n;
  if (i >= n) i -= n;
  return i >= n ? i - n : i;
}

// The CTA's (e0, e1, e2) input window, wrapped periodically.
template <typename T, typename C>
__device__ void load_window(C* __restrict__ s, const T* __restrict__ src,
                            const LevelT<C>& g, const int* b, int e0, int e1,
                            int e2) {
  const int o0 = b[0] - g.left[0], o1 = b[1] - g.left[1],
            o2 = b[2] - g.left[2];
  const int total = e0 * e1 * e2;
  const Split3 split(e1, e2);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int l0, l1, l2;
    split(i, l0, l1, l2);
    const long long g0 = wrap3(o0 + l0, g.n[0]);
    const long long g1 = wrap3(o1 + l1, g.n[1]);
    const int g2 = wrap3(o2 + l2, g.n[2]);
    s[i] = to_f(src[(g0 * g.n[1] + g1) * g.n[2] + g2]);
  }
}

// out = K-tap correlation of `in` (d0, d1, d2) along axis A, keeping `to`
// outputs on that axis: out[c] = sum_j tp[j] * in[c + j e_A] (the pass of
// nddwt_level.cu, with the index split by multiply-high).
template <int A, bool ACCUM, typename C>
__device__ void stage_pass(C* __restrict__ out, const C* __restrict__ in,
                           int d0, int d1, int d2, int to,
                           const C* __restrict__ tp, int K) {
  const int o0 = A == 0 ? to : d0;
  const int o1 = A == 1 ? to : d1;
  const int o2 = A == 2 ? to : d2;
  const int stride = A == 2 ? 1 : (A == 1 ? d2 : d1 * d2);
  const int total = o0 * o1 * o2;
  const Split3 split(o1, o2);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int c0, c1, c2;
    split(i, c0, c1, c2);
    const C* p = in + (c0 * d1 + c1) * d2 + c2;
    C acc = 0;
    for (int j = 0; j < K; ++j) acc = mad(tp[j], p[j * stride], acc);
    if (ACCUM)
      out[i] += acc;
    else
      out[i] = acc;
  }
}

// Analysis over halo slots HA < HB: input i (of n_in, one view's extent
// apart) gives sub-band s = bitA + 2 bitB as output d = s + 4 i, written to
// dst0 for d == 0 and to big[band_off + d - 1] otherwise, soft-thresholded
// by lam > 0 when d > 0. smem: the window, then the HA-pass intermediate.
// (The lane analysis; the lead analysis streams, nddwt_stream.cuh.)
template <typename T, int HA, int HB, typename C>
__device__ void dec_stage(C* __restrict__ smem, C (*taps)[2][kMaxTaps],
                          const T* __restrict__ src, int n_in,
                          const LevelT<C>& g, T* __restrict__ dst0,
                          T* __restrict__ big, long long band_off, C lam) {
  copy_taps(taps, g);
  int b[3];
  tile_origin(g, b);
  const int t0 = g.t[0], t1 = g.t[1], t2 = g.t[2];
  const int e0 = t0 + g.k[0] - 1, e1 = t1 + g.k[1] - 1, e2 = t2 + g.k[2] - 1;
  const int d1 = HA == 1 ? t1 : e1, d2 = HA == 2 ? t2 : e2;  // intermediate
  const int strideB = HB == 2 ? 1 : d2;
  C* s0 = smem;
  C* p1 = s0 + e0 * e1 * e2;
  const long long vox = (long long)g.n[0] * g.n[1] * g.n[2];
  const int nsA = g.k[HA] > 1 ? 2 : 1;
  const bool hiB = g.k[HB] > 1;
  const int KB = g.k[HB];
  const C* tl = taps[HB][0];
  const C* th = taps[HB][1];
  const Split3 split(t1, t2);
  for (int i = 0; i < n_in; ++i) {
    __syncthreads();  // the previous input's window and intermediate are read
    load_window(s0, src + i * vox, g, b, e0, e1, e2);
    __syncthreads();
    for (int sa = 0; sa < nsA; ++sa) {
      stage_pass<HA, false>(p1, s0, e0, e1, e2, g.t[HA], taps[HA][sa],
                            g.k[HA]);
      __syncthreads();
      const int dlo = sa + 4 * i, dhi = dlo + 2;
      T* lo_dst = dlo == 0 ? dst0 : big + (band_off + dlo - 1) * vox;
      T* hi_dst = hiB ? big + (band_off + dhi - 1) * vox : nullptr;
      const bool shrink_lo = dlo != 0 && lam > 0, shrink_hi = lam > 0;
      for (int o = threadIdx.x; o < t0 * t1 * t2; o += blockDim.x) {
        int c0, c1, c2;
        split(o, c0, c1, c2);
        const int q0 = b[0] + c0, q1 = b[1] + c1, q2 = b[2] + c2;
        if (q0 >= g.n[0] || q1 >= g.n[1] || q2 >= g.n[2]) continue;
        const C* p = p1 + (c0 * d1 + c1) * d2 + c2;
        C lo = 0, hi = 0;
        for (int j = 0; j < KB; ++j) {
          const C v = p[j * strideB];
          lo = mad(tl[j], v, lo);
          hi = mad(th[j], v, hi);
        }
        const long long q = ((long long)q0 * g.n[1] + q1) * g.n[2] + q2;
        lo_dst[q] = from_f<T>(shrink_lo ? shrink(lo, lam) : lo);
        if (hiB) hi_dst[q] = from_f<T>(shrink_hi ? shrink(hi, lam) : hi);
      }
      __syncthreads();  // the intermediate is rewritten by the next pass
    }
  }
}

// Synthesis over halo slots HA < HB: output group gi (of n_out, written one
// view's extent apart) is scale * the sum over s of the adjoint of sub-band
// s applied to band d = s + 4 gi, read from y[src.idx[d]] or, for -1, from
// approx. The taps arrive reversed and the halo mirrored, so each adjoint
// is a forward correlation. smem: window, intermediate, output tile.
template <typename T, int HA, int HB, typename C>
__device__ void adj_stage(C* __restrict__ smem, C (*taps)[2][kMaxTaps],
                          const T* __restrict__ y, const T* __restrict__ approx,
                          const Sources& src, int n_out, const LevelT<C>& g,
                          T* __restrict__ out, C scale) {
  copy_taps(taps, g);
  int b[3];
  tile_origin(g, b);
  const int t0 = g.t[0], t1 = g.t[1], t2 = g.t[2];
  const int e0 = t0 + g.k[0] - 1, e1 = t1 + g.k[1] - 1, e2 = t2 + g.k[2] - 1;
  const int d0 = HA == 0 ? t0 : e0, d1 = HA == 1 ? t1 : e1,
            d2 = HA == 2 ? t2 : e2;
  C* s0 = smem;
  C* p1 = s0 + e0 * e1 * e2;
  C* acc = p1 + d0 * d1 * d2;
  const long long vox = (long long)g.n[0] * g.n[1] * g.n[2];
  const int nsA = g.k[HA] > 1 ? 2 : 1, nsB = g.k[HB] > 1 ? 2 : 1;
  const int p1n = d0 * d1 * d2, an = t0 * t1 * t2;
  const Split3 split(t1, t2);
  for (int gi = 0; gi < n_out; ++gi) {
    for (int i = threadIdx.x; i < an; i += blockDim.x) acc[i] = 0;
    for (int sb = 0; sb < nsB; ++sb) {
      for (int i = threadIdx.x; i < p1n; i += blockDim.x) p1[i] = 0;
      for (int sa = 0; sa < nsA; ++sa) {
        const long long id = src.idx[sa + 2 * sb + 4 * gi];
        const T* bsrc = id < 0 ? approx : y + id * vox;
        __syncthreads();  // the previous band's window is consumed
        load_window(s0, bsrc, g, b, e0, e1, e2);
        __syncthreads();
        stage_pass<HA, true>(p1, s0, e0, e1, e2, g.t[HA], taps[HA][sa],
                             g.k[HA]);
      }
      __syncthreads();
      stage_pass<HB, true>(acc, p1, d0, d1, d2, g.t[HB], taps[HB][sb],
                           g.k[HB]);
      __syncthreads();
    }
    T* dst = out + gi * vox;
    for (int i = threadIdx.x; i < an; i += blockDim.x) {
      int c0, c1, c2;
      split(i, c0, c1, c2);
      const int q0 = b[0] + c0, q1 = b[1] + c1, q2 = b[2] + c2;
      if (q0 >= g.n[0] || q1 >= g.n[1] || q2 >= g.n[2]) continue;
      dst[((long long)q0 * g.n[1] + q1) * g.n[2] + q2] = from_f<T>(acc[i] * scale);
    }
  }
}

// Lane analysis: x (X*Y, Z, T) -> temp (4, X*Y, Z, T), band c at temp[c].
template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    lane_dec_kernel(const T* __restrict__ x, T* __restrict__ temp,
                    const __grid_constant__ LevelT<C> g) {
  __shared__ C taps[3][2][kMaxTaps];
  dec_stage<T, 1, 2>(shared_words<C>(), taps, x, 1, g, temp, temp, 1, C(0));
}

// Lane adjoint: partial (4, X*Y, Z, T) -> scale * (X*Y, Z, T).
template <typename T, typename C = compute_t<T>>
__global__ void __launch_bounds__(kThreads)
    lane_adj_kernel(const T* __restrict__ partial, T* __restrict__ out,
                    const __grid_constant__ LevelT<C> g,
                    const __grid_constant__ Sources src, C scale) {
  __shared__ C taps[3][2][kMaxTaps];
  adj_stage<T, 1, 2>(shared_words<C>(), taps, partial, partial, src, 1,
                            g, out, scale);
}

template <typename C>
LevelT<C> stage_level(const int* n, const int* k, const int* t, const int* left,
                      const int* pad, const void* taps) {
  const int no_bits[3] = {0, 0, 0};  // the stage kernels fix their band bits
  return make_level<C>(n, k, t, left, no_bits, taps, pad);
}

// Dynamic shared memory: window + intermediate (+ output tile for adjoints).
template <typename C>
size_t stage_smem(const LevelT<C>& g, int ha, bool adj) {
  size_t e[3], d[3];
  for (int a = 0; a < 3; ++a) d[a] = e[a] = g.t[a] + g.k[a] - 1;
  d[ha] = g.t[ha];
  size_t w = e[0] * e[1] * e[2] + d[0] * d[1] * d[2];
  if (adj) w += (size_t)g.t[0] * g.t[1] * g.t[2];
  return w * sizeof(C);
}

template <typename C, typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), const LevelT<C>& g, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles(g), kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The view's geometry: n, k, t, left, pad (3 ints each; pad nullptr: no
// slot halo-padded) and the taps.
struct Geom {
  const int *n, *k, *t, *left, *pad;
  const void* taps;
};

// The lane body's launch (nddwt_lane.cuh): t = (R, Zc, stages); one wave
// of persistent CTAs (as many as fit the SMs at this shared memory), at
// most one a unit.
template <typename T, typename C, typename... KArgs, typename... Args>
int launch_lane(void (*kernel)(KArgs...), const LevelT<C>& g, int nin, bool adj,
                cudaStream_t stream, Args... args) {
  const LanePlan p = lane_plan(g);
  const size_t smem = lane_smem<T, C>(p, nin, adj);
  if (p.stages < 1 || p.stages > kLaneMaxStages || p.Zc < 1 || g.k[1] < 2 ||
      p.Z < g.k[1] || p.T < g.k[2] || p.Ew > p.Z || p.units < 1 ||
      smem > kStreamSmemBudget)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                         smem)) != cudaSuccess)
    return (int)e;
  const int grid = per_sm * sms < p.units ? per_sm * sms : p.units;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, typename C = compute_t<T>>
auto lane_dec_kernel_for(int kt) {
  switch (kt) {
    case 2: return lane_body_dec_kernel<T, 2, C>;
    case 4: return lane_body_dec_kernel<T, 4, C>;
    case 6: return lane_body_dec_kernel<T, 6, C>;
    case 8: return lane_body_dec_kernel<T, 8, C>;
    default: return lane_body_dec_kernel<T, 0, C>;
  }
}

template <typename T, typename C = compute_t<T>>
auto lane_adj_kernel_for(int kt) {
  switch (kt) {
    case 2: return lane_body_adj_kernel<T, 2, C>;
    case 4: return lane_body_adj_kernel<T, 4, C>;
    case 6: return lane_body_adj_kernel<T, 6, C>;
    case 8: return lane_body_adj_kernel<T, 8, C>;
    default: return lane_body_adj_kernel<T, 0, C>;
  }
}

// Whether t is a tile of the tile body's form: at least one output on
// every slot, within the view.
template <typename C>
bool tile_fits(const LevelT<C>& g) {
  for (int a = 0; a < 3; ++a)
    if (g.t[a] < 1 || g.t[a] > g.n[a]) return false;
  return true;
}

// The lane stages run the body the wrapper names: body 0 the lane body on
// its plan (R, Zc, stages), body 1 the tile body on its tile (t0, t1, t2);
// a plan that does not fit the named body returns cudaErrorInvalidValue.
template <typename T, typename C = compute_t<T>>
int lane_dec(const void* x, void* temp, const Geom& v, int body, cudaStream_t s) {
  const LevelT<C> g = stage_level<C>(v.n, v.k, v.t, v.left, v.pad, v.taps);
  if (body == 1)
    return tile_fits(g) ? launch(lane_dec_kernel<T, C>, g, stage_smem(g, 1, false), s,
                                 (const T*)x, (T*)temp, g)
                        : (int)cudaErrorInvalidValue;
  if (body != 0) return (int)cudaErrorInvalidValue;
  return launch_lane<T>(lane_dec_kernel_for<T, C>(lane_unrolled(g.k)), g, 1, false, s,
                        (const T*)x, (T*)temp, g);
}

// The lead analysis streams X (nddwt_stream.cuh) over the (X, Y, Z*T) view:
// t = (C, T1, T2) is its chunk of X and plane tile, gw the in-plane bands
// (of the 2 of slot 1) a walk keeps; input group gi gives band s0 + 2 s1 +
// 4 gi.
template <typename T, typename C = compute_t<T>>
int lead_dec(const void* temp, void* big, void* approx_out, const Geom& v,
             int n_in, long long band_off, double lam, int gw, cudaStream_t s) {
  const int bits[3] = {0, 1, 0};
  const LevelT<C> g = make_level<C>(v.n, v.k, v.t, v.left, bits, v.taps, v.pad);
  return launch_stream_ana<T, 2>((const T*)temp, (T*)big, (T*)approx_out, g, n_in,
                                 gw, band_off, (C)lam, s);
}

// The lead adjoint streams X (nddwt_stream.cuh) over the (X, Y, Z*T) view:
// t = (C, T1, T2) is its chunk of X and plane tile; band s0 + 2 s1 + 4 gi.
template <typename T, typename C = compute_t<T>>
int lead_adj(const void* y, const void* approx, void* partial, const Geom& v,
             const StreamSources& src, int n_out, cudaStream_t s) {
  const int bits[3] = {0, 1, 0};
  const LevelT<C> g = make_level<C>(v.n, v.k, v.t, v.left, bits, v.taps, v.pad);
  return launch_stream<T>((const T*)y, (const T*)approx, (T*)partial, g, src,
                          n_out, C(1), s);
}

template <typename T, typename C = compute_t<T>>
int lane_adj(const void* partial, void* out, const Geom& v, const Sources& src,
             double scale, int body, cudaStream_t s) {
  const LevelT<C> g = stage_level<C>(v.n, v.k, v.t, v.left, v.pad, v.taps);
  if (body == 1)
    return tile_fits(g) ? launch(lane_adj_kernel<T, C>, g, stage_smem(g, 1, true), s,
                                 (const T*)partial, (T*)out, g, src, (C)scale)
                        : (int)cudaErrorInvalidValue;
  if (body != 0) return (int)cudaErrorInvalidValue;
  return launch_lane<T>(lane_adj_kernel_for<T, C>(lane_unrolled(g.k)), g,
                        g.k[2] > 1 ? 4 : 2, true, s, (const T*)partial, (T*)out, g,
                        (C)scale);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float64. n, k, t, left: 3 ints each, the stage's view (slot 0
// slowest; n the output extents); t: the lane stages' plan (R, Zc, stages)
// of the lane body, or the tile body's tile (t0, t1, t2); the lead stages'
// streamed plan (C, T1, T2); body (the lane stages): 0 the lane body, 1 the
// tile body; gw (the lead analysis): its in-plane bands a walk; pad
// (the lead stages, last before the stream): 3 ints, 1 on a halo-padded
// slot, whose inputs then have extent n + k - 1; taps:
// 3 * 2 * 76 of the compute type (float for dtypes 0 and 1,
// double for 2). The caller makes the arrays' device current. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int nddwt_max_taps() { return kMaxTaps; }

extern "C" int nddwt_lane_dec(const void* x, void* temp, int dtype,
                              const int* n, const int* k, const int* t,
                              const int* left, const void* taps, int body,
                              void* stream) {
  const Geom v{n, k, t, left, nullptr, taps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return lane_dec<float>(x, temp, v, body, s);
  if (dtype == 1) return lane_dec<__nv_bfloat16>(x, temp, v, body, s);
  if (dtype == 2) return lane_dec<double>(x, temp, v, body, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_lead_dec(const void* temp, void* big, void* approx_out,
                              int dtype, const int* n, const int* k,
                              const int* t, const int* left, const void* taps,
                              int n_in, long long band_off, double lam,
                              int gw, const int* pad, void* stream) {
  const Geom v{n, k, t, left, pad, taps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return lead_dec<float>(temp, big, approx_out, v, n_in, band_off, lam, gw, s);
  if (dtype == 1)
    return lead_dec<__nv_bfloat16>(temp, big, approx_out, v, n_in, band_off,
                                   lam, gw, s);
  if (dtype == 2)
    return lead_dec<double>(temp, big, approx_out, v, n_in, band_off, lam, gw, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_lead_adj(const void* y, const void* approx, void* partial,
                              int dtype, const int* n, const int* k,
                              const int* t, const int* left, const void* taps,
                              const long long* band_idx, int n_out,
                              const int* pad, void* stream) {
  const Geom v{n, k, t, left, pad, taps};
  StreamSources src;
  for (int d = 0; d < kStreamBands; ++d) src.idx[d] = band_idx[d];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return lead_adj<float>(y, approx, partial, v, src, n_out, s);
  if (dtype == 1)
    return lead_adj<__nv_bfloat16>(y, approx, partial, v, src, n_out, s);
  if (dtype == 2) return lead_adj<double>(y, approx, partial, v, src, n_out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nddwt_lane_adj(const void* partial, void* out, int dtype,
                              const int* n, const int* k, const int* t,
                              const int* left, const void* taps, double scale,
                              int body, void* stream) {
  const Geom v{n, k, t, left, nullptr, taps};
  Sources src;  // partial c is sub-band c
  for (int d = 0; d < kMaxBands; ++d) src.idx[d] = d;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return lane_adj<float>(partial, out, v, src, scale, body, s);
  if (dtype == 1) return lane_adj<__nv_bfloat16>(partial, out, v, src, scale, body, s);
  if (dtype == 2) return lane_adj<double>(partial, out, v, src, scale, body, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nddwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
