// Hopper's warpgroup products (`wgmma.mma_async`) and the fences around
// them, shared by the K2b ring tile (side_tile.cuh) and the ViT's K9/K8
// (vit_attention.cu). sm_90a only.
//
// Operands in shared memory are read through 64-bit descriptors: the start
// address, the byte distance between 8-row groups (SBO) and the swizzle of
// rows that are the swizzle's width (128, 64 or 32 bytes: 8 rows of it are
// one swizzle atom, 1,024 / 512 / 256 bytes, aligned to its size). K-major
// (K contiguous in a row) advances along K by moving the start address;
// MN-major (the `tnspB` form, N contiguous in a row of K) reads k-steps of
// 16 rows, two atoms SBO apart. A from registers takes the `mma.sync`
// m16n8k16 A fragment on each warp's 16 rows of the 64 (mma_frag.cuh's
// layout), and the accumulator of an m64nN product is N / 8 of its C tiles:
// warp w of the group holds rows 16w..16w+15, n8 tile j in d[4j..4j+3].
// Everything here has internal linkage (static: an unnamed namespace here
// would make the names nvcc's host stub gives the includer's own unnamed
// namespace ambiguous under `using namespace gmma`): each .cu is its own
// shared library, loaded into one process.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gmma {

static __device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// this thread's shared-memory writes (stores, finished cp.async) made visible to wgmma's reads
static __device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

static __device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
static __device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
static __device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// N registers pinned in place around asynchronous products: accumulators,
// or register A operands that a product still reads until its wait
template <int N>
static __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, typename I>
static __device__ __forceinline__ void fence_regs(I* d) {
  static_assert(sizeof(I) == 4, "32-bit integer registers");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// descriptor of a shared-memory operand in rows of kRowBytes (128, 64 or
// 32) in the swizzle of that width, 8-row groups 8 * kRowBytes apart,
// aligned to the atom; K-major or, read with tnspB, MN-major (one atom wide
// in N: the distance between atoms is not read)
template <int kRowBytes>
static __device__ __forceinline__ uint64_t gmma_desc_rows(const void* p) {
  static_assert(kRowBytes == 128 || kRowBytes == 64 || kRowBytes == 32, "a swizzle of 128, 64 or 32 bytes");
  constexpr uint64_t layout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (uint64_t)1 << 16 | (uint64_t)(8 * kRowBytes >> 4) << 32 |
         layout << 62;
}

// the byte offset `off` (from a base aligned to the atom) as the swizzle of
// kRowBytes-wide rows places it: 16-byte chunk c of row r at c ^ (r's bits
// above the row), what TMA's SWIZZLE_128B / 64B / 32B write and wgmma reads
template <int kRowBytes>
static __device__ __forceinline__ unsigned swizzle(unsigned off) {
  constexpr unsigned mask = kRowBytes / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

#define GMMA_R(x) "+r"(x)
#define GMMA_F(x) "+f"(x)
#define GMMA_D8(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define GMMA_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 of the warpgroup) (+)= A (64 rows x 32 bytes of K) B^T (64 rows x 32 bytes)
static __device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " GMMA_D32 ", %32, %33, p;\n}\n"
               : GMMA_D8(GMMA_R, 0), GMMA_D8(GMMA_R, 8), GMMA_D8(GMMA_R, 16), GMMA_D8(GMMA_R, 24)
               : "l"(a), "l"(b), "r"(accumulate));
}
static __device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GMMA_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : GMMA_D8(GMMA_F, 0), GMMA_D8(GMMA_F, 8), GMMA_D8(GMMA_F, 16), GMMA_D8(GMMA_F, 24)
               : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N of the warpgroup, fp32) (+)= A (64 x 16 bf16, the register
// fragment a[4]) B (16 x N bf16 from the descriptor b: K-major, or MN-major
// with kTransB); N 16, 32 or 64
template <int N, int kTransB>
static __device__ __forceinline__ void wgmma_rs_bf16(float* d, const uint32_t* a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs_bf16<16, 0>(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
               "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
               : GMMA_D8(GMMA_F, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_bf16<16, 1>(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
               "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
               : GMMA_D8(GMMA_F, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_bf16<32, 1>(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
               "%10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
               : GMMA_D8(GMMA_F, 0), GMMA_D8(GMMA_F, 8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_bf16<64, 0>(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GMMA_D32 ", {%32, %33, %34, %35}, %36, p, "
               "1, 1, 0;\n}\n"
               : GMMA_D8(GMMA_F, 0), GMMA_D8(GMMA_F, 8), GMMA_D8(GMMA_F, 16), GMMA_D8(GMMA_F, 24)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_bf16<64, 1>(float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GMMA_D32 ", {%32, %33, %34, %35}, %36, p, "
               "1, 1, 1;\n}\n"
               : GMMA_D8(GMMA_F, 0), GMMA_D8(GMMA_F, 8), GMMA_D8(GMMA_F, 16), GMMA_D8(GMMA_F, 24)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef GMMA_D32
#undef GMMA_D8
#undef GMMA_F
#undef GMMA_R

}  // namespace gmma
