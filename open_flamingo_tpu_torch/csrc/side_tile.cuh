// K2b side tiles for Hopper (sm_90a): an unrelated GEMM tile carried by K2's
// down-projection launch (dense_stream.cu), as extra blocks after the row
// GEMV's own.
//
//   replaces open_flamingo_tpu/ops/dense_stream.py `side_tile_compute` (the
//   side-stream tile of `_mlp_kernel`, operands from `append_side_operands`,
//   flags from `side_kernel_flags`).
//
//   out (M, N) = act(LN?(x)) @ W^T + bias + residual
//
// x (M, K) contiguous; W (N, K) in torch's nn.Linear layout with a row
// stride, so every slot of the absorbed ViT reads a view of the ViT's own
// weight (an fc2 slice is a column block of its (D, I) weight); residual
// (M, N) with a row stride (an out-projection part reads a column block of
// the workspace). Rounding points, the TPU tile's: the LayerNorm (flax fast
// variance, scale and bias) and the activation in fp32, ONE rounding to x's
// dtype before the product, fp32 accumulation, + bias, + residual, one
// rounding of the result.
//
// Design. The TPU kernel rides one M block of the tile on each grid step of
// the carrier, under the weight stream's DMA. CUDA blocks run in no order:
// here the carrier's grid gets `tiles` more blocks of the same 512 threads
// and shared memory, each one output tile (64 rows x 128 columns in bf16,
// 64 x 64 in fp32), scheduled after the GEMV's blocks, so they run on SMs
// the GEMV leaves or as its blocks retire. The GEMV's blocks run their own
// body on the grid they would have had alone: its output does not change.
// Each side block takes its rows' LayerNorm statistics in one pass over
// the rows (one warp per 4 rows), then walks K in chunks of 32: the chunk of
// x normalised, activated and rounded into shared memory, the chunk of W
// copied beside it, then bf16 `mma.sync` m16n8k16 (fragments by `ldmatrix`,
// rows padded by 8 elements: conflict-free) or fp32 FMA (4 x 2 outputs per
// thread). One buffer, no pipelining: simple first.
//
// Bound of one tile at OF-3B (M 2112, K = N = 1024, bf16): 4.43 GFLOP over
// 989 TFLOP/s, 0.0045 ms, above its 8.6 MB over 3.35 TB/s.
//
// W8A8 side tiles (K2b int8; the TPU tile's `has_side_ws` branch, taken when
// the ViT's int8 side-car is bound): W is int8 with a per-out-channel fp32
// scale ws (N,), and the rows of act(LN?(x)) are quantized in the tile:
//
//   sh = act(LN?(x)) in fp32 (NOT rounded to x's dtype first)
//   s  = amax(|sh|) / 127 over the row's K (1 for a zero row)
//   q  = clip(round_half_even(sh / s), -127, 127)          (true division)
//   out = float(q @ Wq^T) * s * ws[n]  + bias  + residual, one rounding
//
// The int32 sum is exact and the epilogue rounds at the plain version's
// points (the products and sums spelled out, no contraction), so kernel and
// plain version differ only where an activation lands on the other side of a
// rounding boundary: the LayerNorm statistics and the activation are fp32
// sums and functions taken in another order. K is the tile's own: an fc2
// slot quantizes its D-wide slice of the hidden row, not the whole row.
// Design: one pass over each row for the LayerNorm statistics, one for the
// amax of the activated row (a warp per row), then K in chunks of 32: the
// chunk of x activated, quantized and stored as int8 in shared memory beside
// the int8 chunk of W (rows padded to 48 bytes: the ldmatrix row addresses
// fall in distinct banks), and `mma.sync` m16n8k32 s8 x s8 -> s32 on
// Hopper's int8 tensor cores, the fragments loaded by ldmatrix as the bf16
// tile's (a 32-byte row of int8 is a 16-element row of bf16). 64 x 128
// output tiles in both dtypes. Bound of one tile at OF-3B (M 2112, K = N =
// 1024): 4.43 G int8 operations over 1,979 TOP/s, 0.0022 ms, below its
// bytes (x 4.3 MB in bf16, W 1 MB, the output 4.3 MB: 9.7 MB over 3.35 TB/s,
// 0.0029 ms); at B 64 (M 16,896) 35.4 G operations, 0.0179 ms, under 73.4
// MB, 0.0219 ms: bound by the bytes in both.

#pragma once

#include <algorithm>

#include "rows_gemv.cuh"

namespace side {
namespace {

constexpr int kRows = 64;        // M tile; models/absorb_vit.py rounds M to it (SIDE_ROWS)
constexpr int kColsMma = 128;    // N tile, bf16
constexpr int kColsFma = 64;     // N tile, fp32
constexpr int kDepth = 32;       // K chunk; K must be a multiple of it
constexpr int kPad = kDepth + 8; // bf16 elements per staged row
constexpr int kColsI8 = 128;     // N tile of the W8A8 tile, either dtype
constexpr int kPadI8 = kDepth + 16;  // bytes per staged int8 row
constexpr int kThreads = rows::kThreads;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Args {
  const T* x;          // (M, K) contiguous
  const T* w;          // (N, K), rows ldw elements apart; null in the W8A8 tile
  long long ldw;
  const int8_t* wq;    // the W8A8 tile's (N, K) int8 W, rows ldw bytes apart, or null
  const float* ws;     // (N,) fp32 scales of wq
  const T* ln_s;       // (K,) or null: LayerNorm of each x row
  const T* ln_b;       // (K,) or null
  float eps;
  int act;             // rows::Act, on the (normalised) x rows
  const T* bias;       // (N,) or null
  const T* res;        // (M, N), rows ldr elements apart, or null
  long long ldr;
  T* out;              // (M, N) contiguous
  int m, n, k;
};

template <typename T>
__host__ __device__ constexpr int cols() { return std::is_same<T, float>::value ? kColsFma : kColsMma; }

template <typename T>
inline int tiles(const Args<T>& a) {
  return ((a.m + kRows - 1) / kRows) * ((a.n + cols<T>() - 1) / cols<T>());
}

template <typename T>
inline int tiles_i8(const Args<T>& a) {
  return ((a.m + kRows - 1) / kRows) * ((a.n + kColsI8 - 1) / kColsI8);
}

// the W8A8 tile's shared memory: mean, rstd and the row scales, then the
// int8 x and W chunks
inline size_t smem_i8_bytes() { return 3 * kRows * 4 + (size_t)(kRows + kColsI8) * kPadI8; }

// shared memory of one side block: the row statistics, then the x and W chunks
template <typename T>
inline size_t smem_bytes() {
  if (std::is_same<T, float>::value) return 2 * kRows * 4 + (size_t)kDepth * (kRows + 4) * 4 * 2;
  return 2 * kRows * 4 + (size_t)(kRows + kColsMma) * kPad * 2;
}

// mean and 1/sqrt(var + eps) of the block's rows (flax fast variance)
template <typename T>
__device__ void row_stats(const Args<T>& a, int m0, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float s = 0.f, ss = 0.f;
    if (m0 + r < a.m) {
      const T* xr = a.x + (size_t)(m0 + r) * a.k;
      for (int c = lane * rows::kVec; c < a.k; c += 32 * rows::kVec) {
        float v[rows::kVec];
        rows::load8<false>(xr + c, v);
#pragma unroll
        for (int e = 0; e < rows::kVec; ++e) {
          s += v[e];
          ss = fmaf(v[e], v[e], ss);
        }
      }
    }
    s = rows::warp_sum(s);
    ss = rows::warp_sum(ss);
    if (lane == 0) {
      const float mu = s / (float)a.k;
      mean[r] = mu;
      rstd[r] = rsqrtf(fmaxf(0.f, ss / (float)a.k - mu * mu) + a.eps);
    }
  }
}

// the prologue of x element (row r of the block, column c): LN?, act, fp32
template <typename T>
__device__ __forceinline__ float prologue(const Args<T>& a, float v, const float* mean, const float* rstd, int r,
                                          int c) {
  if (a.ln_s != nullptr) {
    v = (v - mean[r]) * rstd[r] * rows::to_f32(a.ln_s[c]);
    if (a.ln_b != nullptr) v += rows::to_f32(a.ln_b[c]);
  }
  return a.act != rows::kNone ? rows::activation(v, a.act) : v;
}

template <typename T>
__device__ __forceinline__ void store(const Args<T>& a, int row, int col, float y) {
  if (row >= a.m || col >= a.n) return;
  if (a.bias != nullptr) y += rows::to_f32(a.bias[col]);
  if (a.res != nullptr) y += rows::to_f32(a.res[(size_t)row * a.ldr + col]);
  a.out[(size_t)row * a.n + col] = rows::from_f32<T>(y);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// One bf16 output tile: 16 warps as 4 (rows) x 4 (columns), each 16 rows x
// 32 columns (four n8 tiles) of fp32 accumulators.
__device__ void tile_bf16(const Args<__nv_bfloat16>& a, int tile, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  float* mean = reinterpret_cast<float*>(smem);
  float* rstd = mean + kRows;
  bf16* xs = reinterpret_cast<bf16*>(rstd + kRows);   // [kRows][kPad]
  bf16* ws = xs + kRows * kPad;                        // [kColsMma][kPad]
  const int n_tiles = (a.n + kColsMma - 1) / kColsMma;
  const int m0 = (tile / n_tiles) * kRows, n0 = (tile % n_tiles) * kColsMma;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (a.ln_s != nullptr) row_stats(a, m0, mean, rstd);
  __syncthreads();

  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int lr = lane % 8, lt = lane / 8;
  for (int k0 = 0; k0 < a.k; k0 += kDepth) {
    const int r = tid / 4, c = (tid % 4) * 8;   // one 8-element vector per thread
    if (r < kRows) {
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < a.m) {
        float v[8];
        rows::load8<false>(a.x + (size_t)(m0 + r) * a.k + k0 + c, v);
        uint32_t* u = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          __nv_bfloat162 p = __floats2bfloat162_rn(prologue(a, v[e], mean, rstd, r, k0 + c + e),
                                                   prologue(a, v[e + 1], mean, rstd, r, k0 + c + e + 1));
          u[e / 2] = *reinterpret_cast<uint32_t*>(&p);
        }
      }
      *reinterpret_cast<uint4*>(xs + r * kPad + c) = packed;
    }
    {
      uint4 wv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < a.n) wv = *reinterpret_cast<const uint4*>(a.w + (size_t)(n0 + r) * a.ldw + k0 + c);
      *reinterpret_cast<uint4*>(ws + r * kPad + c) = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, xs + (wm * 16 + lr + (lt & 1) * 8) * kPad + kk + (lt >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];   // columns 16j..16j+7 at k and k + 8, then 16j+8..16j+15
        ldsm_x4(bf, ws + (wn * 32 + j * 16 + (lt >> 1) * 8 + lr) * kPad + kk + (lt & 1) * 8);
        rows::mma_bf16(acc[2 * j], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        rows::mma_bf16(acc[2 * j + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  // c0, c1: row g, columns 2t, 2t + 1 of each n8 tile; c2, c3: row g + 8
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 4; ++i) store(a, m0 + wm * 16 + g + (i >> 1) * 8, col + (i & 1), acc[nt][i]);
  }
}

// One fp32 output tile on CUDA cores: thread (ty, tx) owns rows 2ty, 2ty + 1
// and columns 4tx .. 4tx + 3; x and W chunks stored K-major.
__device__ void tile_f32(const Args<float>& a, int tile, unsigned char* smem) {
  constexpr int ld = kRows + 4;   // kColsFma == kRows
  float* mean = reinterpret_cast<float*>(smem);
  float* rstd = mean + kRows;
  float* xs = rstd + kRows;       // [kDepth][ld]
  float* ws = xs + kDepth * ld;   // [kDepth][ld]
  const int n_tiles = (a.n + kColsFma - 1) / kColsFma;
  const int m0 = (tile / n_tiles) * kRows, n0 = (tile % n_tiles) * kColsFma;
  const int tid = threadIdx.x;
  if (a.ln_s != nullptr) row_stats(a, m0, mean, rstd);
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  float acc[2][4] = {};
  const int r = tid / 8, c = (tid % 8) * 4;   // one 4-element vector of x and of W per thread
  for (int k0 = 0; k0 < a.k; k0 += kDepth) {
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), wv = xv;
    if (m0 + r < a.m) {
      xv = *reinterpret_cast<const float4*>(a.x + (size_t)(m0 + r) * a.k + k0 + c);
      xv.x = prologue(a, xv.x, mean, rstd, r, k0 + c);
      xv.y = prologue(a, xv.y, mean, rstd, r, k0 + c + 1);
      xv.z = prologue(a, xv.z, mean, rstd, r, k0 + c + 2);
      xv.w = prologue(a, xv.w, mean, rstd, r, k0 + c + 3);
    }
    if (n0 + r < a.n) wv = *reinterpret_cast<const float4*>(a.w + (size_t)(n0 + r) * a.ldw + k0 + c);
    xs[(c + 0) * ld + r] = xv.x;
    xs[(c + 1) * ld + r] = xv.y;
    xs[(c + 2) * ld + r] = xv.z;
    xs[(c + 3) * ld + r] = xv.w;
    ws[(c + 0) * ld + r] = wv.x;
    ws[(c + 1) * ld + r] = wv.y;
    ws[(c + 2) * ld + r] = wv.z;
    ws[(c + 3) * ld + r] = wv.w;
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float x0 = xs[kk * ld + 2 * ty], x1 = xs[kk * ld + 2 * ty + 1];
      const float4 w4 = *reinterpret_cast<const float4*>(ws + kk * ld + 4 * tx);
      acc[0][0] = fmaf(x0, w4.x, acc[0][0]);
      acc[0][1] = fmaf(x0, w4.y, acc[0][1]);
      acc[0][2] = fmaf(x0, w4.z, acc[0][2]);
      acc[0][3] = fmaf(x0, w4.w, acc[0][3]);
      acc[1][0] = fmaf(x1, w4.x, acc[1][0]);
      acc[1][1] = fmaf(x1, w4.y, acc[1][1]);
      acc[1][2] = fmaf(x1, w4.z, acc[1][2]);
      acc[1][3] = fmaf(x1, w4.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store(a, m0 + 2 * ty + i, n0 + 4 * tx + j, acc[i][j]);
}

__device__ __forceinline__ void tile(const Args<__nv_bfloat16>& a, int t, unsigned char* smem) { tile_bf16(a, t, smem); }
__device__ __forceinline__ void tile(const Args<float>& a, int t, unsigned char* smem) { tile_f32(a, t, smem); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One W8A8 output tile (64 rows x 128 columns, either dtype): 16 warps as 4
// (rows) x 4 (columns), each 16 rows x 32 columns (four n8 tiles) of int32
// accumulators; threads 0-255 quantize the x chunk, 256-511 copy W's.
template <typename T>
__device__ void tile_i8(const Args<T>& a, int tile, unsigned char* smem) {
  float* mean = reinterpret_cast<float*>(smem);
  float* rstd = mean + kRows;
  float* sact = rstd + kRows;
  int8_t* xs = reinterpret_cast<int8_t*>(sact + kRows);   // [kRows][kPadI8]
  int8_t* ws = xs + kRows * kPadI8;                        // [kColsI8][kPadI8]
  const int n_tiles = (a.n + kColsI8 - 1) / kColsI8;
  const int m0 = (tile / n_tiles) * kRows, n0 = (tile % n_tiles) * kColsI8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (a.ln_s != nullptr) row_stats(a, m0, mean, rstd);
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps) {   // the row scales: amax of the activated row / 127
    float mx = 0.f;
    if (m0 + r < a.m) {
      const T* xr = a.x + (size_t)(m0 + r) * a.k;
      for (int c = lane * rows::kVec; c < a.k; c += 32 * rows::kVec) {
        float v[rows::kVec];
        rows::load8<false>(xr + c, v);
#pragma unroll
        for (int e = 0; e < rows::kVec; ++e) mx = fmaxf(mx, fabsf(prologue(a, v[e], mean, rstd, r, c + e)));
      }
    }
    mx = warp_max(mx);
    if (lane == 0) sact[r] = mx == 0.f ? 1.f : __fdiv_rn(mx, 127.f);
  }
  __syncthreads();

  const int wm = warp / 4, wn = warp % 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  const int lr = lane % 8, lt = lane / 8;
  for (int k0 = 0; k0 < a.k; k0 += kDepth) {
    if (tid < kRows * 4) {   // 8 activations of row r, quantized
      const int r = tid / 4, c = (tid % 4) * 8;
      uint32_t lo = 0u, hi = 0u;   // bytes e = 0..3 and 4..7
      if (m0 + r < a.m) {
        float v[8];
        rows::load8<false>(a.x + (size_t)(m0 + r) * a.k + k0 + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int q = min(max(__float2int_rn(__fdiv_rn(prologue(a, v[e], mean, rstd, r, k0 + c + e), sact[r])),
                                -127), 127);
          const uint32_t byte = (uint32_t)q & 0xffu;
          if (e < 4) lo |= byte << (8 * e);
          else hi |= byte << (8 * (e - 4));
        }
      }
      *reinterpret_cast<uint2*>(xs + r * kPadI8 + c) = make_uint2(lo, hi);
    } else {                 // 16 bytes of W row r
      const int t = tid - kRows * 4, r = t / 2, c = (t % 2) * 16;
      uint4 wv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < a.n) wv = *reinterpret_cast<const uint4*>(a.wq + (size_t)(n0 + r) * a.ldw + k0 + c);
      *reinterpret_cast<uint4*>(ws + r * kPadI8 + c) = wv;
    }
    __syncthreads();
    uint32_t af[4];
    ldsm_x4(af, xs + (wm * 16 + lr + (lt & 1) * 8) * kPadI8 + (lt >> 1) * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bf[4];   // columns 16j..16j+7 at k bytes 0-15 and 16-31, then 16j+8..16j+15
      ldsm_x4(bf, ws + (wn * 32 + j * 16 + (lt >> 1) * 8 + lr) * kPadI8 + (lt & 1) * 16);
      mma_s8(acc[2 * j], af, bf[0], bf[1]);
      mma_s8(acc[2 * j + 1], af, bf[2], bf[3]);
    }
    __syncthreads();
  }
  // c0, c1: row g, columns 2t, 2t + 1 of each n8 tile; c2, c3: row g + 8
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 16 + g + (i >> 1) * 8, row = m0 + rl, col = n0 + wn * 32 + nt * 8 + 2 * t4 + (i & 1);
      if (row >= a.m || col >= a.n) continue;
      float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][i]), sact[rl]), a.ws[col]);
      if (a.bias != nullptr) y = __fadd_rn(y, rows::to_f32(a.bias[col]));
      if (a.res != nullptr) y = __fadd_rn(y, rows::to_f32(a.res[(size_t)row * a.ldr + col]));
      a.out[(size_t)row * a.n + col] = rows::from_f32<T>(y);
    }
  }
}

template <bool kI8, typename T>
__device__ __forceinline__ void side_tile(const Args<T>& a, int t, unsigned char* smem) {
  if constexpr (kI8) tile_i8(a, t, smem);
  else tile(a, t, smem);
}

// K2's down-projection (and K3's out-projection) carrying side tiles: the
// first `main_blocks` blocks run the row GEMV's body on a grid of
// main_blocks, the rest one side tile each (kI8: the W8A8 tile). Instances
// of their own (kSide): the kernels without side blocks are compiled as they
// were.
template <typename W, bool kI8>
__global__ void __launch_bounds__(kThreads) gemv_mma_side_kernel(
    const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w, rows::Epilogue<__nv_bfloat16> ep,
    __nv_bfloat16* __restrict__ out, int b, int n, int k, int ks, int main_blocks, Args<__nv_bfloat16> sa) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < main_blocks)
    rows::gemv_mma_body<W, __nv_bfloat16, false, rows::kActBase>(x, nullptr, nullptr, 0.f, rows::kLayerNorm, w,
                                                                  nullptr, ep, out, b, n, k, ks, smem, main_blocks,
                                                                  blockIdx.x);
  else
    side_tile<kI8>(sa, blockIdx.x - main_blocks, smem);
}

template <typename T, typename W, bool kI8>
__global__ void __launch_bounds__(kThreads) gemv_side_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ w, rows::Epilogue<T> ep, T* __restrict__ out, int b,
    int n, int k, int rows_per_pass, int main_blocks, Args<T> sa) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < main_blocks)
    rows::gemv_body<T, W, T, false, rows::kActBase>(x, nullptr, nullptr, 0.f, rows::kLayerNorm, w, nullptr, ep, out,
                                                    b, n, k, rows_per_pass, smem, main_blocks, blockIdx.x);
  else
    side_tile<kI8>(sa, blockIdx.x - main_blocks, smem);
}

template <typename T, typename W, bool kI8>
cudaError_t launch_typed(const T* x, const void* w, rows::Epilogue<T> ep, T* out, int b, int n, int k,
                         const Args<T>& sa, cudaStream_t st) {
  const unsigned char* wb = static_cast<const unsigned char*>(w);
  const int side_blocks = kI8 ? tiles_i8(sa) : tiles(sa);
  const size_t side_smem = kI8 ? smem_i8_bytes() : smem_bytes<T>();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (k % rows::kMmaK == 0 && rows::mma_smem(k, false) <= (size_t)rows::smem_optin()) {
      const size_t smem = std::max(rows::mma_smem(k, false), side_smem);
      int ks, blocks;
      rows::mma_grid(n, k, &ks, &blocks);
      auto kern = gemv_mma_side_kernel<W, kI8>;
      static size_t smem_set = 48 * 1024;
      cudaError_t e = rows::allow_smem(kern, smem, smem_set);
      if (e != cudaSuccess) return e;
      kern<<<blocks + side_blocks, kThreads, smem, st>>>(x, wb, ep, out, b, n, k, ks, blocks, sa);
      return cudaGetLastError();
    }
  }
  const int rows_pp = rows::core_rows<T>(b, k);
  if (rows_pp < 1) return cudaErrorInvalidValue;
  const size_t smem = std::max(rows_pp * (size_t)k * sizeof(T), side_smem);
  const int blocks = rows::grid_for(((long long)n + rows::kWarps - 1) / rows::kWarps);
  auto kern = gemv_side_kernel<T, W, kI8>;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = rows::allow_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<blocks + side_blocks, kThreads, smem, st>>>(x, wb, ep, out, b, n, k, rows_pp, blocks, sa);
  return cudaGetLastError();
}

// out (B, N) = epilogue(h @ W^T) as launch_gemv_norm's form without norm,
// activation or gated weight (K2's down-projection, K3's out-projection), W
// stored as wtype says, with the side tile `sa` in the same launch: the W8A8
// tile when sa.wq is set (with sa.ws), else the tile in x's dtype (sa.w).
template <typename T>
cudaError_t launch_gemv_side(int wtype, const T* x, const void* w, rows::Epilogue<T> ep, T* out, int b, int n, int k,
                             const Args<T>& sa, cudaStream_t st) {
  if (k < rows::kVec || k % rows::kVec != 0 || b < 1 || n < 1 || ep.act != rows::kNone) return cudaErrorInvalidValue;
  if (sa.m < 1 || sa.n < 1 || sa.k < kDepth || sa.k % kDepth != 0 || sa.act < rows::kNone || sa.act > rows::kSilu)
    return cudaErrorInvalidValue;
  const bool i8 = sa.wq != nullptr;
  if (i8 ? (sa.ws == nullptr || sa.w != nullptr || sa.ldw % 16 != 0) : (sa.w == nullptr || sa.ws != nullptr))
    return cudaErrorInvalidValue;
  switch (wtype * 2 + i8) {
    case 0: return launch_typed<T, T, false>(x, w, ep, out, b, n, k, sa, st);
    case 1: return launch_typed<T, T, true>(x, w, ep, out, b, n, k, sa, st);
    case 2: return launch_typed<T, int8_t, false>(x, w, ep, out, b, n, k, sa, st);
    case 3: return launch_typed<T, int8_t, true>(x, w, ep, out, b, n, k, sa, st);
    case 4: return launch_typed<T, rows::Int4, false>(x, w, ep, out, b, n, k, sa, st);
    case 5: return launch_typed<T, rows::Int4, true>(x, w, ep, out, b, n, k, sa, st);
    default: return cudaErrorInvalidValue;
  }
}

// The side tile's arguments from the C interface: side_ws set means side_w
// is int8 (the W8A8 tile).
template <typename T>
Args<T> args(const void* x, const void* w, long long ldw, const void* ws, const void* ln_s, const void* ln_b,
             float eps, int act, const void* bias, const void* res, long long ldr, void* out, int m, int n, int k) {
  const bool i8 = ws != nullptr;
  return Args<T>{(const T*)x, i8 ? nullptr : (const T*)w, ldw, i8 ? (const int8_t*)w : nullptr, (const float*)ws,
                 (const T*)ln_s, (const T*)ln_b, eps, act, (const T*)bias, (const T*)res, ldr, (T*)out, m, n, k};
}

}  // namespace
}  // namespace side
