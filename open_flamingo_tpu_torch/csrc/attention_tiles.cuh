// Tile helpers of the tensor-core attention bodies: the prefill forward
// K4/K5 (prefill_attention.cu) and its backward K4b/K5b
// (attention_backward.cu). bf16 rows staged into shared memory by
// `cp.async` with a padded row stride, the bf16 pair stores of an
// accumulator's two columns, the warp's union of key intervals, and the
// launch shape: 16-row tiles over blocks of a few warps, sized so that the
// grid fills the card's SMs. Everything here has internal linkage: each .cu
// is its own shared library, loaded into one process.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

// bf16 elements per staged K or V row: Dh padded to DP, then 8 more, so the
// eight rows an `ldmatrix` reads fall in distinct banks
template <int DP>
__host__ __device__ constexpr int row_stride() { return DP + 8; }

// rows [r0, r0 + n) of x (rows x d) into dst (n rows of KS elements), by
// threads tid, tid + nthreads, ...: zeros past `rows` and past d. `vec`:
// 16 bytes a `cp.async` (the caller commits); otherwise element by element.
template <int DP>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* x, int r0, int n, int rows,
                                          int d, bool vec, int tid, int nthreads) {
  constexpr int KS = row_stride<DP>();
  if (vec) {
    for (int idx = tid; idx < n * (DP / 8); idx += nthreads) {
      const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
      const bool real = r0 + r < rows && c < d;
      cp_async16(dst + r * KS + c, x + (real ? (size_t)(r0 + r) * d + c : 0), real);
    }
  } else {
    const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
    for (int idx = tid; idx < n * DP; idx += nthreads) {
      const int r = idx / DP, c = idx % DP;
      dst[r * KS + c] = r0 + r < rows && c < d ? x[(size_t)(r0 + r) * d + c] : zero;
    }
  }
}

// columns c, c + 1 of row r of x (rows x d), rounded to bf16; those past d dropped
__device__ __forceinline__ void store_pair(__nv_bfloat16* x, int r, int c, int d, float v0, float v1) {
  __nv_bfloat16* p = x + (size_t)r * d + c;
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
    return;
  }
  if (c < d) p[0] = __float2bfloat16(v0);
  if (c + 1 < d) p[1] = __float2bfloat16(v1);
}

// the union of the warp's key intervals: the least lo and the largest hi
__device__ __forceinline__ void warp_range(int* lo, int* hi) {
  for (int o = 16; o > 0; o >>= 1) {
    *lo = min(*lo, __shfl_xor_sync(0xffffffffu, *lo, o));
    *hi = max(*hi, __shfl_xor_sync(0xffffffffu, *hi, o));
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// `rows`' 16-row tiles over blocks of at most `max_warps` warps, evenly:
// with fewer warps a block (more blocks) while the grid would not give every
// SM `fill` blocks. (blocks per instance, warps)
void block_shape(int rows, int bh, int fill, int max_warps, int* blocks, int* warps) {
  const int tiles = (rows + 15) / 16;
  int w = min(max_warps, tiles);
  while (w > 1 && (long long)((tiles + w - 1) / w) * bh < (long long)fill * sm_count()) --w;
  *blocks = (tiles + w - 1) / w;
  *warps = (tiles + *blocks - 1) / *blocks;
}

// Once per instance (a flag of internal linkage): raise the kernel's
// dynamic shared-memory limit to `bytes`, and ask for the SM's largest
// shared-memory carveout, so that as many blocks share an SM as their
// shared memory allows (the kernels read global memory mostly through
// `cp.async`)
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

}  // namespace
