// K2b side tiles for Hopper (sm_90a): an unrelated GEMM tile carried by K2's
// down-projection launch (dense_stream.cu) or K3's out-projection launch
// (decode_layer.cu, K2b-attn), as extra blocks after the row GEMV's own.
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
// the carrier, under the weight stream's DMA, and prepares that block once
// for the whole width. CUDA blocks run in no order: here the carrier's grid
// gets more blocks of the same 512 threads and shared memory, scheduled
// after the GEMV's, so they run on SMs the GEMV leaves or as its blocks
// retire. The GEMV's blocks run their own body on the grid they would have
// had alone: its output does not change.
//
// The ring tile (bf16 and W8A8, `tile_ring`). One side block owns 64 rows
// and a span of columns: all of N where the row blocks alone fill the card,
// else N cut into equal spans of 256-column passes until blocks >= SMs (the
// host computes the span: ops/dense_stream.py `side_span`). The block
// 1. starts the ring: cp.async copies of W's first chunks, 128 bytes of K
//    for each of a pass's 256 rows (32 KB a stage, zero-filled past N and
//    SK), under everything that follows;
// 2. prepares its rows ONCE for the whole SK, a warp per row holding it in
//    registers: the LayerNorm statistics in `row_stats`' order, the W8A8 row
//    scale (the amax of the activated row), then act(LN?(x)) rounded to
//    bf16, or quantized to int8, written to shared memory in the 128-byte
//    swizzled K-major layout `wgmma` reads (64 x SK bytes in int8, 64 x 2 SK
//    in bf16);
// 3. walks its span in passes of 256 columns, each of the 4 warpgroups 64 of
//    them in 32 accumulator registers, K chunk by K chunk through a ring of
//    3 stages (bf16) or 5 (int8): `wgmma.mma_async` m64n64k32 s8 x s8 -> s32
//    or m64n64k16 bf16 -> fp32, both operands from shared memory, the next
//    stages loading while the products run; each pass ends in the epilogue
//    while the next pass's first stages arrive.
// The tile takes SK up to 1,024 (kMaxK), ViT-L/14's width: there a warp
// holds a row in registers, and the prepared rows and the ring fill 225 KB
// of the 227 KB a block may hold.
//
// The fp32 tile (`tile_f32`, the fp32 gates only): one 64 x 64 output tile a
// block, K in chunks of 32 through shared memory, FMA on CUDA cores.
//
// Bound of one bf16 tile at OF-3B (M 2112, K = N = 1024): 4.43 GFLOP over
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
// slot quantizes its D-wide slice of the hidden row, not the whole row. The
// row statistics, scales and quantization are those of the first W8A8 tile
// (64 x 128 output tiles, each preparing its rows again), so q, and with it
// the output, is that tile's bit for bit. Bound of one tile at OF-3B (M
// 2112, K = N = 1024): 4.43 G int8 operations over 1,979 TOP/s, 0.0022 ms,
// below its bytes (x 4.3 MB in bf16, W 1 MB, the output 4.3 MB: 9.7 MB over
// 3.35 TB/s, 0.0029 ms); at B 64 (M 16,896) 35.4 G operations, 0.0179 ms,
// under 73.4 MB, 0.0219 ms: bound by the bytes in both. Each block reads all
// of its span's W from L2 (264 MB at B 64): the L2's rate, not the HBM's,
// is the floor this design meets.

#pragma once

#include <algorithm>
#include <type_traits>

#include "rows_gemv.cuh"
#include "gmma.cuh"
#include "rows_stream.cuh"

namespace side {
namespace {

using namespace ::gmma;   // wgmma, its descriptors and fences

constexpr int kRows = 64;        // M block; models/absorb_vit.py rounds M to it (SIDE_ROWS)
constexpr int kColsFma = 64;     // N tile of the fp32 tile
constexpr int kDepth = 32;       // K granule; K must be a multiple of it
constexpr int kThreads = rows::kThreads;
constexpr int kWarps = kThreads / 32;
// the ring tile
constexpr int kGroups = kThreads / 128;           // warpgroups
constexpr int kGroupCols = 64;                    // a warpgroup's accumulator: 64 rows x 64 columns
constexpr int kPassCols = kGroups * kGroupCols;   // 256; a span is whole passes
constexpr int kChunk = 128;                       // bytes of K in a staged row: one 128-byte swizzle row
constexpr int kAtom = kRows * kChunk;             // one K chunk of the prepared rows
constexpr int kStage = kPassCols * kChunk;        // one K chunk of a pass's W rows: a ring stage
constexpr int kMaxK = 1024;                       // the ring tile's SK at most: a row in a warp's registers

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
  int span;            // the ring tile's columns per block, a multiple of kPassCols
};

// whether the tile of x type T runs the ring (bf16, and W8A8 in either dtype)
template <typename T>
__host__ __device__ constexpr bool ring_tile(bool i8) { return i8 || !std::is_same<T, float>::value; }

// bytes of one prepared row: SK int8 activations or bf16 values, whole chunks
__host__ __device__ constexpr int ring_row_bytes(int k, bool i8) { return (k * (i8 ? 1 : 2) + kChunk - 1) / kChunk * kChunk; }

// the ring's stages: what fits beside the prepared rows at kMaxK (128 KB in
// bf16, 64 KB in int8)
__host__ __device__ constexpr int ring_stages(bool i8) { return i8 ? 5 : 3; }

// the ring tile's shared memory: room to align to 1 KB, the prepared rows,
// the stages, the W8A8 row scales
__host__ __device__ constexpr size_t ring_smem(int k, bool i8) {
  return 1024 + (size_t)kRows * ring_row_bytes(k, i8) + (size_t)ring_stages(i8) * kStage + kRows * 4;
}
static_assert(ring_smem(kMaxK, false) <= 232448 && ring_smem(kMaxK, true) <= 232448,
              "the ring tile at kMaxK within sm_90's opt-in shared memory of a block");

// the fp32 tile's shared memory: the row statistics, then the x and W chunks
inline size_t smem_f32_bytes() { return 2 * kRows * 4 + (size_t)kDepth * (kRows + 4) * 4 * 2; }

template <typename T>
inline int side_blocks(const Args<T>& a, bool i8) {
  const int row_blocks = (a.m + kRows - 1) / kRows;
  return row_blocks * (ring_tile<T>(i8) ? (a.n + a.span - 1) / a.span : (a.n + kColsFma - 1) / kColsFma);
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes global -> shared through L2 alone; zero-filled where !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// One 128-byte K chunk of a warpgroup's 64 x 64 product: xa the prepared
// rows' chunk, wb its 64 W rows' chunk, four steps of 32 bytes; `first`: the
// pass's first chunk, whose products start the sums. The accumulators are
// wgmma's m64n64 layout: warp w of the group on rows 16w..16w+15, n8 tile j
// in d[4j..4j+3]. Issued and committed here, waited for by the caller.
template <bool kI8, typename Acc>
__device__ __forceinline__ void chunk_products(Acc* d, const unsigned char* xa, const unsigned char* wb, bool first) {
  fence_regs<32>(d);
  wgmma_fence();
  const uint64_t da = gmma_desc_rows<128>(xa), db = gmma_desc_rows<128>(wb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // 32 bytes of K a step: the start address moves 2 x 16 bytes
    if constexpr (kI8) wgmma_s8(d, da + 2 * j, db + 2 * j, first && j == 0 ? 0 : 1);
    else wgmma_bf16(d, da + 2 * j, db + 2 * j, first && j == 0 ? 0 : 1);
  }
  wgmma_commit();
}

template <int kAct>
__device__ __forceinline__ void activation8(float* v) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = rows::activation(v[e], kAct);
}

// `prologue` of 8 consecutive values of one row (columns c..c+7) in place,
// its arithmetic with each condition tested once for the 8: the column's
// LayerNorm scale and bias read 8 at a time
template <typename T>
__device__ __forceinline__ void prologue8(const Args<T>& a, float* v, float mean, float rstd, int c) {
  if (a.ln_s != nullptr) {
    float s[8];
    rows::load8<false>(a.ln_s + c, s);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rstd * s[e];
    if (a.ln_b != nullptr) {
      float b[8];
      rows::load8<false>(a.ln_b + c, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += b[e];
    }
  }
  switch (a.act) {
    case rows::kGelu: activation8<rows::kGelu>(v); break;
    case rows::kGeluNew: activation8<rows::kGeluNew>(v); break;
    case rows::kRelu: activation8<rows::kRelu>(v); break;
    case rows::kQuickGelu: activation8<rows::kQuickGelu>(v); break;
    case rows::kSilu: activation8<rows::kSilu>(v); break;
    default: break;
  }
}

constexpr int kRowVec = kMaxK / 256;   // 8-element vectors a lane holds of a row: kMaxK columns a warp

// 8 consecutive values of x as loaded (16 or 32 bytes), converted when used
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ void fetch8(const T* p, Raw8<T>& raw) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) raw.u[i] = reinterpret_cast<const uint4*>(p)[i];
}
__device__ __forceinline__ void unpack8(const Raw8<float>& raw, float* v) {
  const float* f = reinterpret_cast<const float*>(raw.u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = f[e];
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(raw.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The block's rows once for the whole SK, a warp per row, lane l on columns
// 8l + 256i + e (row_stats' order): the LayerNorm statistics (row_stats'
// sums), the W8A8 row scale (the amax of the activated row / 127, 1 for a
// zero row), then act(LN?(x)) quantized, q = clip(rn(h / s_act), -127,
// 127), or rounded to bf16, in the swizzled K-major layout: 16-byte chunk
// cc of row r at K chunk cc / 8, row r, position (cc % 8) ^ (r % 8). A row
// is read once, into registers, while the warp works on its previous row.
// Rows past M and columns past SK are zero.
template <typename T, bool kI8>
__device__ void prepare_rows(const Args<T>& a, int m0, int row_bytes, unsigned char* xs, float* sact) {
  constexpr int kEs = kI8 ? 1 : 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vecs = row_bytes / kEs / 8;   // 8-element vectors of a prepared row
  auto column = [&](int i) { return 8 * (lane + 32 * i); };
  Raw8<T> next[kRowVec];                  // the warp's next row, fetched ahead
  auto fetch = [&](int r) {
#pragma unroll
    for (int i = 0; i < kRowVec; ++i)
      if (m0 + r < a.m && column(i) < a.k) fetch8(a.x + (size_t)(m0 + r) * a.k + column(i), next[i]);
  };
  fetch(warp);
  for (int r = warp; r < kRows; r += kWarps) {
    const bool live = m0 + r < a.m;
    auto valid = [&](int i) { return live && column(i) < a.k; };
    float v[kRowVec][8];
#pragma unroll
    for (int i = 0; i < kRowVec; ++i) unpack8(next[i], v[i]);
    if (r + kWarps < kRows) fetch(r + kWarps);
    float mean = 0.f, rstd = 0.f, scale = 1.f;
    if (a.ln_s != nullptr) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < kRowVec; ++i) {
        if (!valid(i)) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[i][e];
          ss = fmaf(v[i][e], v[i][e], ss);
        }
      }
      s = rows::warp_sum(s);   // every lane holds lane 0's sums: the butterfly's pairs commute
      ss = rows::warp_sum(ss);
      mean = s / (float)a.k;
      rstd = rsqrtf(fmaxf(0.f, ss / (float)a.k - mean * mean) + a.eps);
    }
#pragma unroll
    for (int i = 0; i < kRowVec; ++i)
      if (valid(i)) prologue8(a, v[i], mean, rstd, column(i));
    if constexpr (kI8) {
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < kRowVec; ++i) {
        if (!valid(i)) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[i][e]));
      }
      mx = warp_max(mx);
      scale = mx == 0.f ? 1.f : __fdiv_rn(mx, 127.f);
      if (lane == 0) sact[r] = scale;
    }
#pragma unroll
    for (int i = 0; i < kRowVec; ++i) {
      const int j = column(i) / 8;   // vector j: columns 8j..8j+7
      if (j >= vecs) continue;
      if constexpr (kI8) {           // 8 bytes: half of chunk j / 2
        uint32_t u[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int q = valid(i) ? min(max(__float2int_rn(__fdiv_rn(v[i][e], scale)), -127), 127) : 0;
          u[e / 4] |= ((uint32_t)q & 0xffu) << (8 * (e % 4));
        }
        const int cc = j / 2;
        *reinterpret_cast<uint2*>(xs + (cc / 8) * kAtom + r * kChunk + (((cc % 8) ^ (r % 8)) * 16) + (j % 2) * 8) =
            make_uint2(u[0], u[1]);
      } else {                       // 16 bytes: chunk j
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (valid(i)) {
          uint32_t* u = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            __nv_bfloat162 p = __floats2bfloat162_rn(v[i][e], v[i][e + 1]);
            u[e / 2] = *reinterpret_cast<uint32_t*>(&p);
          }
        }
        *reinterpret_cast<uint4*>(xs + (j / 8) * kAtom + r * kChunk + (((j % 8) ^ (r % 8)) * 16)) = packed;
      }
    }
  }
}

// One output of the ring tile from its fp32 (bf16 tile) or int32 (W8A8)
// sum, the column's weight scale ws and bias b and the residual res read:
// W8A8 s * ws first, then + b, + res, as `__fmul_rn` / `__fadd_rn` (the plain
// version's order, no contraction); bf16 `store`'s; one rounding.
template <typename T, bool kI8, typename Acc>
__device__ __forceinline__ T ring_out(const Args<T>& a, Acc acc, float s_row, float ws, T b, T res) {
  if constexpr (kI8) {
    float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), ws);
    if (a.bias != nullptr) y = __fadd_rn(y, rows::to_f32(b));
    if (a.res != nullptr) y = __fadd_rn(y, rows::to_f32(res));
    return rows::from_f32<T>(y);
  } else {
    float y = acc;
    if (a.bias != nullptr) y += rows::to_f32(b);
    if (a.res != nullptr) y += rows::to_f32(res);
    return rows::from_f32<T>(y);
  }
}

// A warpgroup's 64 x 64 outputs at columns n0.. (< c_end): each lane's two
// adjacent columns, their scales, biases and residuals read and written as
// one access each where both columns lie inside and N is even (aligned),
// else one by one.
template <typename T, bool kI8, typename Acc>
__device__ __forceinline__ void ring_epilogue(const Args<T>& a, const Acc* d, int m0, int n0, int c_end,
                                              const float* sact) {
  using Pair = typename std::conditional<std::is_same<T, float>::value, float2, __nv_bfloat162>::type;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4, r0 = (threadIdx.x / 32) % 4 * 16 + g;
  const bool paired = a.n % 2 == 0;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int col = n0 + nb * 8 + 2 * t4;
    if (col >= c_end) continue;
    const int cols = col + 1 < c_end ? 2 : 1;
    const bool two = paired && cols == 2;
    float ws[2] = {0.f, 0.f};
    Pair bp;
    T* b2 = reinterpret_cast<T*>(&bp);
    if (two) {
      if constexpr (kI8) *reinterpret_cast<float2*>(ws) = *reinterpret_cast<const float2*>(a.ws + col);
      if (a.bias != nullptr) bp = *reinterpret_cast<const Pair*>(a.bias + col);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e >= cols) continue;
        if constexpr (kI8) ws[e] = a.ws[col + e];
        if (a.bias != nullptr) b2[e] = a.bias[col + e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // d[4nb + 2h], d[4nb + 2h + 1]: row r0 + 8h, columns col, col + 1
      const int rl = r0 + 8 * h, row = m0 + rl;
      if (row >= a.m) continue;
      const float s_row = kI8 ? sact[rl] : 0.f;
      T* out = a.out + (size_t)row * a.n + col;
      Pair rp, op;
      T* r2 = reinterpret_cast<T*>(&rp);
      T* o2 = reinterpret_cast<T*>(&op);
      if (two) {
        if (a.res != nullptr) rp = *reinterpret_cast<const Pair*>(a.res + (size_t)row * a.ldr + col);
        o2[0] = ring_out<T, kI8>(a, d[4 * nb + 2 * h], s_row, ws[0], b2[0], r2[0]);
        o2[1] = ring_out<T, kI8>(a, d[4 * nb + 2 * h + 1], s_row, ws[1], b2[1], r2[1]);
        *reinterpret_cast<Pair*>(out) = op;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e >= cols) continue;
          if (a.res != nullptr) r2[e] = a.res[(size_t)row * a.ldr + col + e];
          out[e] = ring_out<T, kI8>(a, d[4 * nb + 2 * h + e], s_row, ws[e], b2[e], r2[e]);
        }
      }
    }
  }
}

// One ring block (see the note at the top): block `blk` of the side grid,
// row block blk / spans, span blk % spans.
template <typename T, bool kI8>
__device__ void tile_ring(const Args<T>& a, int blk, unsigned char* smem) {
  using Acc = typename std::conditional<kI8, int, float>::type;
  constexpr int kEs = kI8 ? 1 : 2;   // bytes of a prepared element, and of a W element
  const int row_bytes = ring_row_bytes(a.k, kI8), kchunks = row_bytes / kChunk, k_bytes = a.k * kEs;
  constexpr int stages = ring_stages(kI8);
  constexpr int keep = kI8 ? 1 : 0;           // product groups left in flight past a chunk
  constexpr int ahead = stages - 1 - keep;    // W stages loading ahead of the products: 2 or 3
  unsigned char* xs = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  unsigned char* ring = xs + (size_t)kRows * row_bytes;
  float* sact = reinterpret_cast<float*>(ring + (size_t)stages * kStage);   // the W8A8 row scales
  const int spans = (a.n + a.span - 1) / a.span;
  const int m0 = blk / spans * kRows, c0 = blk % spans * a.span, c_end = min(c0 + a.span, a.n);
  const int total = (c_end - c0 + kPassCols - 1) / kPassCols * kchunks;   // ring stages of the block
  const unsigned char* w = kI8 ? reinterpret_cast<const unsigned char*>(a.wq) : reinterpret_cast<const unsigned char*>(a.w);
  const long long ldw = a.ldw * kEs;

  // stage s: pass s / kchunks, K chunk s % kchunks; a 16-byte copy per thread and row chunk
  auto load = [&](int s) {
    unsigned char* slot = ring + (size_t)(s % stages) * kStage;
    const int n0 = c0 + s / kchunks * kPassCols, kb0 = s % kchunks * kChunk;
    for (int i = threadIdx.x; i < kPassCols * 8; i += kThreads) {
      const int r = i / 8, c = i % 8, n = n0 + r, kb = kb0 + c * 16;
      const bool valid = n < c_end && kb < k_bytes;
      cp_async16(smem_u32(slot + r * kChunk + ((c ^ (r % 8)) * 16)), valid ? w + n * ldw + kb : w, valid);
    }
  };

  for (int s = 0; s < ahead; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  prepare_rows<T, kI8>(a, m0, row_bytes, xs, sact);

  const int group = threadIdx.x / 128;
  Acc d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;
  for (int it = 0; it < total; ++it) {
    // stage `it` has landed for every thread; the slot refilled next was read by products that are done
    cp_async_wait<ahead - 1>();
    fence_async_smem();
    __syncthreads();
    if (it + ahead < total) load(it + ahead);
    cp_async_commit();
    // a warpgroup whose columns lie past the span's end multiplies W's zeros and stores nothing: a branch
    // on it would serialize the wgmma (ptxas cannot prove it uniform over the warpgroup)
    const int kc = it % kchunks, n0 = c0 + it / kchunks * kPassCols + group * kGroupCols;
    chunk_products<kI8>(d, xs + (size_t)kc * kAtom, ring + (size_t)(it % stages) * kStage + group * kGroupCols * kChunk,
                        kc == 0);
    if (kc == kchunks - 1) {
      wgmma_wait<0>();
      fence_regs<32>(d);
      ring_epilogue<T, kI8>(a, d, m0, n0, c_end, sact);
    } else {
      wgmma_wait<keep>();
      fence_regs<32>(d);
    }
  }
  cp_async_wait<0>();
}

template <bool kI8, typename T>
__device__ __forceinline__ void side_tile(const Args<T>& a, int t, unsigned char* smem) {
  if constexpr (ring_tile<T>(kI8)) tile_ring<T, kI8>(a, t, smem);
  else tile_f32(a, t, smem);
}

// K2's down-projection and K3's out-projection carrying side tiles: the
// first blocks run the row GEMV's body, the rest one side block each (kI8:
// the W8A8 tile). Instances of their own (kSide): the kernels without side
// blocks are compiled as they were. In bf16 gemv_stream_side_kernel, the
// weight-streaming body of rows_stream.cuh on its plan's blocks; in fp32
// gemv_side_kernel, the CUDA-core body on its own grid.
template <typename W, bool kI8>
__global__ void __launch_bounds__(kThreads, 1) gemv_stream_side_kernel(
    const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w, rows::Epilogue<__nv_bfloat16> ep,
    __nv_bfloat16* __restrict__ out, int b, int n, int k, rows::StreamPlan plan, rows::StreamSplit split,
    Args<__nv_bfloat16> sa) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if ((int)blockIdx.x < plan.blocks)
    rows::stream_body<W, __nv_bfloat16, false, rows::kActBase>(x, nullptr, nullptr, 0.f, rows::kLayerNorm, w, nullptr,
                                                                ep, out, b, n, k, plan, split, smem, plan.blocks,
                                                                blockIdx.x);
  else
    side_tile<kI8>(sa, blockIdx.x - plan.blocks, smem);
}

template <typename T, typename W, bool kI8>
__global__ void __launch_bounds__(kThreads) gemv_side_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ w, rows::Epilogue<T> ep, T* __restrict__ out, int b,
    int n, int k, int rows_per_pass, int main_blocks, Args<T> sa) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if ((int)blockIdx.x < main_blocks)
    rows::gemv_body<T, W, T, false, rows::kActBase>(x, nullptr, nullptr, 0.f, rows::kLayerNorm, w, nullptr, ep, out,
                                                    b, n, k, rows_per_pass, smem, main_blocks, blockIdx.x);
  else
    side_tile<kI8>(sa, blockIdx.x - main_blocks, smem);
}

// The bf16 carrier: the first pass of 64 rows carries the tile, the rest
// (no path makes them) are launches of the body alone
template <typename W, bool kI8>
cudaError_t launch_stream_side(const __nv_bfloat16* x, const void* w, rows::Epilogue<__nv_bfloat16> ep,
                               __nv_bfloat16* out, int b, int n, int k, const Args<__nv_bfloat16>& sa,
                               const rows::StreamPlan& plan, const rows::StreamSplit& split, cudaStream_t st) {
  if (!rows::stream_plan_ok<W>(plan, split, n, k)) return cudaErrorInvalidValue;
  const size_t smem = std::max(rows::kStreamSmem, ring_smem(sa.k, kI8));
  auto kern = gemv_stream_side_kernel<W, kI8>;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = rows::allow_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int rows0 = std::min(rows::kStreamRows, b);
  const int ks = rows::stream_slices<W>(plan, k);
  rows::StreamSplit first = split;
  first.defer = rows0 > 8 && ks > 1;  // as the launch without a tile: its bits
  kern<<<plan.blocks + side_blocks(sa, kI8), kThreads, smem, st>>>(
      x, static_cast<const unsigned char*>(w), ep, out, rows0, n, k, plan, first, sa);
  e = cudaGetLastError();
  if (e == cudaSuccess && first.defer)
    e = rows::launch_stream_reduce<!std::is_same<W, __nv_bfloat16>::value, false, rows::kActBase>(
        first, ep, out, rows0, n, (n + rows::kStreamCols - 1) / rows::kStreamCols, ks, st);
  if (e != cudaSuccess || b == rows0) return e;
  rows::Epilogue<__nv_bfloat16> rest = ep;
  if (ep.residual != nullptr) rest.residual += (size_t)rows0 * n;
  return rows::launch_stream_typed<W, false, rows::kActBase>(x + (size_t)rows0 * k, nullptr, nullptr, 0.f,
                                                             rows::kLayerNorm, w, nullptr, rest, out + (size_t)rows0 * n,
                                                             b - rows0, n, k, plan, split, st);
}

// The fp32 carrier: the CUDA-core body on its own grid
template <typename W, bool kI8>
cudaError_t launch_core_side(const float* x, const void* w, rows::Epilogue<float> ep, float* out, int b, int n, int k,
                             const Args<float>& sa, cudaStream_t st) {
  const int side = side_blocks(sa, kI8);
  const size_t side_smem = ring_tile<float>(kI8) ? ring_smem(sa.k, kI8) : smem_f32_bytes();
  const int rows_pp = rows::core_rows<float>(b, k);
  if (rows_pp < 1) return cudaErrorInvalidValue;
  const size_t smem = std::max(rows_pp * (size_t)k * sizeof(float), side_smem);
  const int blocks = rows::grid_for(((long long)n + rows::kWarps - 1) / rows::kWarps);
  auto kern = gemv_side_kernel<float, W, kI8>;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = rows::allow_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<blocks + side, kThreads, smem, st>>>(x, static_cast<const unsigned char*>(w), ep, out, b, n, k, rows_pp,
                                              blocks, sa);
  return cudaGetLastError();
}

template <typename T, typename W, bool kI8>
cudaError_t launch_typed(const T* x, const void* w, rows::Epilogue<T> ep, T* out, int b, int n, int k,
                         const Args<T>& sa, const rows::StreamPlan* plan, const rows::StreamSplit& split,
                         cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return plan == nullptr ? cudaErrorInvalidValue
                           : launch_stream_side<W, kI8>(x, w, ep, out, b, n, k, sa, *plan, split, st);
  else
    return launch_core_side<W, kI8>(x, w, ep, out, b, n, k, sa, st);
}

// out (B, N) = epilogue(h @ W^T) as launch_gemv_norm's form without norm,
// activation or gated weight (K2's down-projection, K3's out-projection), W
// stored as wtype says, with the side tile `sa` in the same launch: the W8A8
// tile when sa.wq is set (with sa.ws), else the tile in x's dtype (sa.w).
// The ring tile takes a span of whole passes and SK up to kMaxK. bf16 runs
// the weight-streaming body on the caller's `plan` and `split`, fp32 the
// CUDA-core body.
template <typename T>
cudaError_t launch_gemv_side(int wtype, const T* x, const void* w, rows::Epilogue<T> ep, T* out, int b, int n, int k,
                             const Args<T>& sa, cudaStream_t st, const rows::StreamPlan* plan = nullptr,
                             rows::StreamSplit split = {}) {
  if (k < rows::kVec || k % rows::kVec != 0 || b < 1 || n < 1 || ep.act != rows::kNone) return cudaErrorInvalidValue;
  if (sa.m < 1 || sa.n < 1 || sa.k < kDepth || sa.k % kDepth != 0 || sa.act < rows::kNone || sa.act > rows::kSilu)
    return cudaErrorInvalidValue;
  const bool i8 = sa.wq != nullptr;
  if (i8 ? (sa.ws == nullptr || sa.w != nullptr || sa.ldw % 16 != 0) : (sa.w == nullptr || sa.ws != nullptr))
    return cudaErrorInvalidValue;
  if (ring_tile<T>(i8) && (sa.span < kPassCols || sa.span % kPassCols != 0 || sa.k > kMaxK))
    return cudaErrorInvalidValue;
  switch (wtype * 2 + i8) {
    case 0: return launch_typed<T, T, false>(x, w, ep, out, b, n, k, sa, plan, split, st);
    case 1: return launch_typed<T, T, true>(x, w, ep, out, b, n, k, sa, plan, split, st);
    case 2: return launch_typed<T, int8_t, false>(x, w, ep, out, b, n, k, sa, plan, split, st);
    case 3: return launch_typed<T, int8_t, true>(x, w, ep, out, b, n, k, sa, plan, split, st);
    case 4: return launch_typed<T, rows::Int4, false>(x, w, ep, out, b, n, k, sa, plan, split, st);
    case 5: return launch_typed<T, rows::Int4, true>(x, w, ep, out, b, n, k, sa, plan, split, st);
    default: return cudaErrorInvalidValue;
  }
}

// The side tile's arguments from the C interface: side_ws set means side_w
// is int8 (the W8A8 tile).
template <typename T>
Args<T> args(const void* x, const void* w, long long ldw, const void* ws, const void* ln_s, const void* ln_b,
             float eps, int act, const void* bias, const void* res, long long ldr, void* out, int m, int n, int k,
             int span) {
  const bool i8 = ws != nullptr;
  return Args<T>{(const T*)x, i8 ? nullptr : (const T*)w, ldw, i8 ? (const int8_t*)w : nullptr, (const float*)ws,
                 (const T*)ln_s, (const T*)ln_b, eps, act, (const T*)bias, (const T*)res, ldr, (T*)out, m, n, k,
                 span};
}

}  // namespace
}  // namespace side
