// What the one-launch kernels share: a persistent grid whose passes are
// separated by grid-wide barriers, its cooperative launch, and the band
// bookkeeping of the multilevel loop.
//
// A one-launch kernel runs every level (and every iteration) of a
// transform inside one launch: each pass is a grid-stride loop over its
// work items, and `grid_barrier()` separates a pass from the next one that
// reads what it wrote. That needs every CTA resident at once, which a
// cooperative launch guarantees: `launch_cooperative` sizes the grid from
// the occupancy of the kernel on this device (never above the co-resident
// limit, which the launch would refuse) and no larger than the largest
// pass needs.
//
// Band layout (the TPU kernels' `_dec_dispatch`/`_rec_dispatch` tails): B =
// 2^d + (2^d - 1)(L - 1) bands, band 0 the deepest approximation, then the
// detail groups deepest first. Analysis level l (0 = finest) writes its
// 2^d - 1 details from `dec_detail_offset(B, nb, l)`; synthesis level l (0 =
// deepest) reads band b >= 1 at `rec_band_index(nb, l, b)`, and band 0 from
// the previous level's output (l > 0) or from band 0 (l = 0).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// First work item of this thread and the grid's stride, for passes of
// fewer than 2^31 items (the wrappers check the count).
__device__ __forceinline__ unsigned int first_item() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ unsigned int item_stride() {
  return gridDim.x * blockDim.x;
}

__host__ __device__ __forceinline__ int dec_detail_offset(int nbands, int nb,
                                                          int lvl) {
  return nbands - (nb - 1) * (lvl + 1);
}

__host__ __device__ __forceinline__ int rec_band_index(int nb, int lvl, int b) {
  return lvl == 0 ? b : nb + (nb - 1) * (lvl - 1) + b - 1;
}

// Launch `kernel(args)` on a cooperative grid of `threads`-thread CTAs with
// `smem` bytes of dynamic shared memory each: as many as fit the device at
// once, capped at what `max_items` work items need, `per_cta` of them to a
// CTA (a thread's worth, `threads`, unless given: the flat kernels; one
// unit, 1: the multilevel kernels). Returns the launch's cudaError_t (0 on
// success): a shared-memory size or grid the device refuses is an error,
// never a smaller launch.
template <typename Args>
int launch_cooperative(void (*kernel)(Args), const Args& args,
                       long long max_items, int threads,
                       cudaStream_t stream, size_t smem = 0,
                       int per_cta = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (per_cta < 1) per_cta = threads;
  long long want = (max_items + per_cta - 1) / per_cta;
  if (want < 1) want = 1;
  const long long most = (long long)per_sm * sms;
  const int grid = (int)(want < most ? want : most);
  void* params[] = {const_cast<Args*>(&args)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(threads), params, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace
