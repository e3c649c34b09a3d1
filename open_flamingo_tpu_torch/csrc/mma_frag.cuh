// Tensor-core fragment helpers shared by the attention kernels: the prefill
// forward K4/K5 (prefill_attention.cu), its backward K4b/K5b
// (attention_backward.cu) and the ViT's K9/K8 (vit_attention.cu: its q
// fragments by `ldmatrix`, P's packing and the quad reductions; its products
// are `wgmma`, gmma.cuh). `mma.sync` m16n8k16 bf16 with fp32 accumulation,
// `ldmatrix` B fragments out of shared memory, `cp.async` staging, and the
// quad reductions over the four lanes that share an accumulator row.
// Everything here has internal linkage: each .cu is its own shared library,
// loaded into one process.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k 2t, 2t + 1
// and 2t + 8, 2t + 9 of column n = g; C holds rows g and g + 8, columns 2t
// and 2t + 1. An 8 x 8 tile by `ldmatrix` gives lane l row l / 4, columns
// 2(l % 4), 2(l % 4) + 1 (K rows: B of q.k^T), and with `.trans` rows
// 2(l % 4), 2(l % 4) + 1 of column l / 4 (V rows: B of P.V). The C tiles of
// keys 16t..16t+7 and 16t+8..16t+15 are, as they stand, the A operand of
// k-step t of P.V, so P never goes through shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// close the group of the copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// four 8 x 8 b16 tiles from shared memory; lane l gives the address of row
// l % 8 of tile l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// P as the hi/lo pair of an fp32 product with exact bf16 operands: hi =
// bf16(p), lo = bf16(p - hi), so hi + lo is p within 2^-17 of its value
// and two `mma.sync` (hi, then lo) sum the fp32 P times V in fp32
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
