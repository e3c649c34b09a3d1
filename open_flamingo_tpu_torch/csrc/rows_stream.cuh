// The weight-streaming row GEMV of the decode kernels in bf16 (sm_90a):
// every bf16 launch of fused_dense and fused_mlp (csrc/dense_stream.cu) and
// of K3's and K6's projections (csrc/decode_layer.cu), the K2 and K3
// carriers of K2b side tiles (csrc/side_tile.cuh) and every row-GEMV phase
// of K11 (csrc/fused_layer.cu) run this body.
//
//   out[r, n] = epilogue( sum_k h[r, k] * W[n, k] )     r < B <= 64 in one pass
//
// What it computes is rows_gemv.cuh's (h = x, LN(x) or RMSNorm(x) times the
// norm's scale rounded to bf16; fp32 sums; the epilogue rows::epilogue in the
// TPU kernels' order; W in bf16, int8 or packed int4 with its scale first in
// the epilogue; the gated form's second weight Wg in the same pass). Only the
// order of the K sums differs from the CUDA-core body's.
//
// Design. At decode batch sizes every weight byte is used B times, so W's
// bytes over 3.35 TB/s bound the launch; the body keeps W streaming and
// touches every weight once whatever B is:
// * W streams through a shared-memory ring. Each warp owns 16 columns of a
//   256-column tile and fills its own ring (Geometry: 4 or 6 stages, half as
//   many of W and Wg in the gated form) with cp.async: a stage is 128 bytes of K of each of its
//   16 rows (64 bf16, 128 int8 or 256 int4 values), 2 KB, copied in 16-byte
//   pieces (8 or 4 where an int row is not 16-byte aligned) and zero-filled
//   past N and K, so ragged N and K need no other path. The pieces land in
//   mma fragment order: lane l's A fragment of a 32-wide K chunk is one
//   conflict-free 16-, 8- or 4-byte read, converted from int8 / int4 to bf16
//   exactly (offset-binary magic numbers, int8_pair / int4_pair). No warp
//   waits for another's copies, so the ring runs on across K slices, h
//   slices and column tiles: 96 to 160 KB in flight per SM, the first stages
//   issued before anything else the block does.
// * The rows' statistics (LayerNorm mean and 1/std, or the RMS) are taken
//   once per block while the first stages land, a warp per row; then h is
//   normalised, rounded to bf16 and staged per K slice (32 or 64 KB: 512 to
//   4,096 values of each row) in fragment order, never whole: no K is too
//   long.
// * All rows of the call, up to 64, are the mma's N dimension: mma.sync
//   m16n8k16, ceil(B/8) n-tiles against each A fragment, so W is read and an
//   int weight converted once for any B. (wgmma would need B's tile width
//   when compiling: one instance per width, and a branch around it
//   serialises it; mma.sync takes B at run time.) Two instances: B <= 8
//   with one n-tile, and any B with eight, whose products are specialised
//   to 1, 2, 4 or 8 live n-tiles.
// * Blocks are persistent, one per SM (the registers of 512 threads allow
//   no second), and walk items: a column tile and a K
//   slice. The plan (ops/dense_stream.py `stream_plan`, passed in) cuts K
//   into slices of whole stages so that the items fill the SMs; with more
//   than one slice, each item's fp32 partial sums go to a scratch the
//   wrapper allocates, and the block that brings a tile's count to the slice
//   count adds the slices' partials in slice order and runs the epilogue,
//   then sets the count back to 0 for the next launch. No atomic touches a
//   sum. Past 8 rows (the B 64 pipe) one block would read B x 256 x 4 bytes
//   per slice alone, so the launch defers: a second kernel
//   (gemv_stream_reduce_kernel) adds the same partials in the same order, a
//   thread per four outputs.
// A column's sums depend on the plan alone, which follows from (N, K, the
// weight type, the SM count): each warp adds its chunks in K order, two
// k16 products each, and the slices add in slice order. Not on B, the grid,
// or side blocks beside the body's, so a row alone gives the bits it gives
// in any batch, a carrier's output (K2's, K3's) is the same with and without
// its K2b tile, and K11's phases on K3's and K2's plans give their bits.
//
// The body is a producer (StreamRing: each warp's walk over the items, the
// stages it has issued) and a consumer (stream_consume). A launch of its own
// (stream_body) runs the producer's first stages, then the consumer. K11
// issues each phase's first stages before the grid barrier its rows wait
// for, and runs the consumer in passes of 64 rows (kPersist).
//
// The norm's arithmetic and the epilogue are spelled out the same way in
// every instance (the LayerNorm's bias as one FMA, rows::epilogue's kCg
// roundings: y * tanh(gate) + residual rounded twice), so K11's instances,
// whose inputs are read through L2 alone (kCg: X fp32, R fp32), give the
// separate launches' bits on equal inputs.

#pragma once

#include "rows_gemv.cuh"

namespace rows {
namespace {

constexpr int kStreamCols = kWarps * 16;  // a column tile: 16 per warp
constexpr int kStreamRows = 64;           // rows of one pass: 8 n-tiles
constexpr int kSegBytes = 128;            // bytes of K of each W row a stage holds
constexpr int kWarpStage = 16 * kSegBytes;  // a warp's 16 rows of a stage

// The two instances' geometry, one block per SM each. kMaxNt 8 (any B up
// to 64): 4 ring stages a warp (2 of W and Wg), 128 KB, and a 64 KB h slice;
// the carriers and K11 past 8 rows run it. kMaxNt 1 (B <= 8, the decode batch): one
// n-tile's registers leave room for a deeper ring, 6 stages (3 of W and Wg),
// 192 KB, and a 32 KB h slice: 160 KB in flight per SM through the
// prologue, the h slices and a split's tail.
template <int kMaxNt, bool kGated>
struct Geometry {
  static constexpr int kStages = kMaxNt == 1 ? (kGated ? 3 : 6) : (kGated ? 2 : 4);
  static constexpr int kStageBytes = kWarpStage * (1 + kGated);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kHBytes = kMaxNt == 1 ? 32 * 1024 : 64 * 1024;
  static constexpr size_t kSmem = kRingBytes + kHBytes + 2 * kStreamRows * sizeof(float) + 16;
};
constexpr size_t kStreamSmem = Geometry<8, false>::kSmem;  // the carriers' (either form)
static_assert(Geometry<8, true>::kSmem == kStreamSmem && Geometry<1, true>::kSmem == Geometry<1, false>::kSmem &&
                  Geometry<1, true>::kRingBytes == Geometry<1, false>::kRingBytes &&
                  Geometry<8, true>::kRingBytes == Geometry<8, false>::kRingBytes,
              "one layout for both forms of an instance: the carriers and K11's phases share it");
static_assert(Geometry<1, false>::kSmem <= 232448 && Geometry<1, true>::kSmem <= 232448,
              "the B <= 8 instance within sm_90's opt-in shared memory of a block");

// 32-wide K chunks in a stage of W stored as W
template <typename W>
__host__ __device__ constexpr int seg_chunks() {
  return std::is_same<W, Int4>::value ? 8 : std::is_same<W, int8_t>::value ? 4 : 2;
}

// How the body cuts its work: `slice` ring stages of K per item, `blocks`
// the grid it walks the items with (ops/dense_stream.py `stream_plan`).
struct StreamPlan {
  int slice, blocks;
};

// A split K's fp32 partials (slices x tiles x 256 columns x B rounded to 8,
// twice in the gated form) and one arrival count per column tile, zero
// before and after a launch.
struct StreamSplit {
  float* scratch;
  int* counters;
  int ncount;
  int defer;  // the partials only: gemv_stream_reduce_kernel adds them and runs the epilogue (B > 8)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// `size` bytes (16, 8 or 4) global -> shared, `bytes` of them read, the rest zero-filled
template <int kSize>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int bytes) {
  if constexpr (kSize == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(kSize), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// 16 bytes of a W row (`valid` of them inside it) to a ring slot, in pieces of the row's alignment
__device__ __forceinline__ void copy_piece(unsigned dst, const unsigned char* src, const unsigned char* any,
                                           int valid, int align) {
  if (align == 16) {
    cp_async<16>(dst, valid ? src : any, valid);
  } else if (align == 8) {
#pragma unroll
    for (int u = 0; u < 16; u += 8) {
      const int v = min(max(valid - u, 0), 8);
      cp_async<8>(dst + u, v ? src + u : any, v);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 16; u += 4) {
      const int v = min(max(valid - u, 0), 4);
      cp_async<4>(dst + u, v ? src + u : any, v);
    }
  }
}

// Where 16-byte piece p (0..7) of row r (0..15) of a warp's stage lands: in
// fragment order, lane 4g + t's bytes of 32-wide chunk cs for row g (+8 h)
// at ((cs * 2 + h) * 32 + 4g + t) * (16, 8 or 4). A bf16 piece is one
// lane's 8 values, an int8 piece two lanes' (t, t + 1), an int4 piece a whole
// chunk of the row (t = 0..3).
template <typename W>
__device__ __forceinline__ int piece_offset(int r, int p) {
  const int g = r & 7, h = r >> 3;
  if constexpr (std::is_same<W, Int4>::value) return ((p * 2 + h) * 32 + 4 * g) * 4;
  else if constexpr (std::is_same<W, int8_t>::value) return (((p >> 1) * 2 + h) * 32 + 4 * g + 2 * (p & 1)) * 8;
  else return (((p >> 2) * 2 + h) * 32 + 4 * g + (p & 3)) * 16;
}

// Two int8 values, bytes j and j + 1 of t = w ^ 0x80808080 (offset binary), as
// bf16x2, exactly: 2^23 + 128 + q placed as a float's bits, less 2^23 + 128
__device__ __forceinline__ uint32_t int8_pair(uint32_t t, int j) {
  const float lo = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7540 | j)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7540 | (j + 1))) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Two int4 values, the low (element 2k) and high (2k + 1) nibble of byte k of
// t = w ^ 0x88888888 (offset binary, lo and hi its nibbles spread to bytes), as
// bf16x2, exactly: 0x4300 | nibble is the bf16 128 + nibble, less 136
__device__ __forceinline__ uint32_t int4_pair(uint32_t lo, uint32_t hi, int k) {
  const uint32_t sel = k | k << 4 | (4 + k) << 8 | (4 + k) << 12;
  const uint32_t v = (__byte_perm(lo, hi, sel) & 0x00ff00ffu) | 0x43004300u;
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  x = __hsub2(x, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&x);
}

// lane's A fragment of chunk cs, half h (rows g or g + 8), from a warp's stage, as 8 bf16
template <typename W>
__device__ __forceinline__ uint4 ring_frag(const unsigned char* stage, int cs, int h, int lane) {
  const int slot = (cs * 2 + h) * 32 + lane;
  if constexpr (std::is_same<W, Int4>::value) {
    const uint32_t t = reinterpret_cast<const uint32_t*>(stage)[slot] ^ 0x88888888u;
    const uint32_t lo = t & 0x0f0f0f0fu, hi = (t >> 4) & 0x0f0f0f0fu;
    return make_uint4(int4_pair(lo, hi, 0), int4_pair(lo, hi, 1), int4_pair(lo, hi, 2), int4_pair(lo, hi, 3));
  } else if constexpr (std::is_same<W, int8_t>::value) {
    const uint2 u = reinterpret_cast<const uint2*>(stage)[slot];
    const uint32_t x = u.x ^ 0x80808080u, y = u.y ^ 0x80808080u;
    return make_uint4(int8_pair(x, 0), int8_pair(x, 2), int8_pair(y, 0), int8_pair(y, 2));
  } else {
    return reinterpret_cast<const uint4*>(stage)[slot];
  }
}

// Mean and 1/std (LayerNorm, flax fast variance) or 0 and 1/RMS of rows
// 0..b-1 of x, a warp per row, in stage_fragments' lane order, every rounding
// spelled out. kCg: x is read through L2 alone.
template <int kBatch, bool kCg, typename X>
__device__ void stream_stats(const X* __restrict__ x, float eps, int norm, int b, int k, float* mean, float* inv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < b; r += kWarps) {
    const X* xr = x + (size_t)r * k;
    float s = 0.f, ss = 0.f;
    for (int c0 = lane * kVec; c0 < k; c0 += kBatch * 32 * kVec) {  // kBatch loads in flight, summed in order
      float v[kBatch][kVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (c0 + u * 32 * kVec < k) load8x<kCg>(xr + c0 + u * 32 * kVec, v[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u * 32 * kVec >= k) break;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s += v[u][e];
          ss = fmaf(v[u][e], v[u][e], ss);
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float m = norm == kRmsNorm ? 0.f : __fdiv_rn(s, (float)k);
      const float var = norm == kRmsNorm ? __fdiv_rn(ss, (float)k)
                                         : fmaxf(0.f, __fsub_rn(__fdiv_rn(ss, (float)k), __fmul_rn(m, m)));
      mean[r] = m;
      inv[r] = rsqrtf(__fadd_rn(var, eps));
    }
  }
}

// Stages h's 32-wide chunks [c0, c0 + nch) of rows 0..8*nts-1 into `hf` in
// fragment order: the 16 bytes of h[8j + g][32c + 8t ..] at ((c - c0) * nts
// + j) * 32 + 4g + t, the B fragment of lane 4g + t for n-tile j; zeros past
// b and k. Consecutive threads write consecutive slots.
template <int kBatch, bool kCg, typename X>
__device__ void stream_stage_h(const X* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s,
                               const __nv_bfloat16* __restrict__ ln_b, const float* mean, const float* inv, int b,
                               int k, int nts, int c0, int nch, uint4* hf) {
  const int per_chunk = nts * 32, total = nch * per_chunk;
  if constexpr (std::is_same<X, __nv_bfloat16>::value) {
    if (ln_s == nullptr) {  // bf16 rows without a norm go as they are, eight slots in flight
      for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
        uint4 raw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + u * kThreads, cl = idx / per_chunk, rem = idx - cl * per_chunk;
          const int r = (rem >> 5) * 8 + ((rem & 31) >> 2), c = (c0 + cl) * 32 + (rem & 3) * kVec;
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          if (idx < total && r < b && c < k) {
            const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * k + c);
            if constexpr (kCg) raw[u] = __ldcg(src);
            else raw[u] = *src;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (base + u * kThreads < total) hf[base + u * kThreads] = raw[u];
      }
      return;
    }
  }
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {  // kBatch slots' rows in flight
    float v[kBatch][kVec];
    bool live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads, cl = idx / per_chunk, rem = idx - cl * per_chunk;
      const int r = (rem >> 5) * 8 + ((rem & 31) >> 2), c = (c0 + cl) * 32 + (rem & 3) * kVec;
      live[u] = idx < total && r < b && c < k;
      if (live[u]) load8x<kCg>(x + (size_t)r * k + c, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= total) break;
      uint4 frag = make_uint4(0u, 0u, 0u, 0u);
      if (live[u]) {
        const int cl = idx / per_chunk, rem = idx - cl * per_chunk;
        const int r = (rem >> 5) * 8 + ((rem & 31) >> 2), c = (c0 + cl) * 32 + (rem & 3) * kVec;
        if (ln_s != nullptr) {
          float s8[kVec], b8[kVec];
          load8<false>(ln_s + c, s8);
          if (ln_b != nullptr) load8<false>(ln_b + c, b8);
          const float m = mean[r], iv = inv[r];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float p = __fmul_rn(__fsub_rn(v[u][e], m), iv);
            v[u][e] = ln_b != nullptr ? __fmaf_rn(p, s8[e], b8[e]) : __fmul_rn(p, s8[e]);
          }
        }
        uint32_t* w2 = reinterpret_cast<uint32_t*>(&frag);  // fp32 rows without a norm round to bf16 once
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          __nv_bfloat162 pair = __floats2bfloat162_rn(v[u][e], v[u][e + 1]);
          w2[e / 2] = *reinterpret_cast<uint32_t*>(&pair);
        }
      }
      hf[idx] = frag;
    }
  }
}

// One ring stage's products for a warp: its `chunks` 32-wide K chunks of W
// (and Wg) against h's n-tiles from `hb` (this lane's slot of the stage's
// first chunk), two k16 mma each in K order. NT: the n-tiles compiled, nts of
// them live (NT 1 and 2 exact, 4 and 8 test each), so B <= 8 issues no
// product for an empty n-tile.
template <int NT, typename W, bool kGated>
__device__ __forceinline__ void stage_products(float (&acc)[8][4], float (&gacc)[8][4], const unsigned char* stage,
                                               const uint4* hb, int nts, int chunks, int lane) {
  constexpr int kSc = seg_chunks<W>();
#pragma unroll
  for (int cs = 0; cs < kSc; ++cs) {
    if (cs >= chunks) break;
    const uint4 a0 = ring_frag<W>(stage, cs, 0, lane), a1 = ring_frag<W>(stage, cs, 1, lane);
    uint4 g0, g1;
    if constexpr (kGated) {
      g0 = ring_frag<W>(stage + kWarpStage, cs, 0, lane);
      g1 = ring_frag<W>(stage + kWarpStage, cs, 1, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (NT <= 2 || j < nts) {
        const uint4 bf = hb[(cs * nts + j) * 32];
        mma_bf16(acc[j], a0.x, a1.x, a0.y, a1.y, bf.x, bf.y);  // K = 32c + 8t + 0..3
        mma_bf16(acc[j], a0.z, a1.z, a0.w, a1.w, bf.z, bf.w);  // K = 32c + 8t + 4..7
        if constexpr (kGated) {
          mma_bf16(gacc[j], g0.x, g1.x, g0.y, g1.y, bf.x, bf.y);
          mma_bf16(gacc[j], g0.z, g1.z, g0.w, g1.w, bf.z, bf.w);
        }
      }
    }
  }
}

// A warp's producer of the ring for one row GEMV: the next (item, stage) it
// copies and how many stages it has issued. Lane l copies piece l % 8 of rows
// l / 8 + 4i (i < 4): one 128-byte row segment per 8 lanes. kPersist (K11):
// the walk runs on over the passes of 64 rows (the items again), so that one
// phase's stream runs across its passes, and a block may issue a phase's
// first stages before the grid barrier that its rows wait for.
template <typename W, bool kGated, int kMaxNt, bool kPersist = false>
struct StreamRing {
  using G = Geometry<kMaxNt, kGated>;
  const unsigned char* w;
  const unsigned char* wg;
  unsigned char* mine;  // this warp's stages
  size_t rb;
  int align, nst, ks, tiles, items, walk, n, slice, grid, p8, r8, row0;
  int p_item, p_st, issued;

  __device__ __forceinline__ StreamRing(const unsigned char* w_, const unsigned char* wg_, int n_, int k, int b,
                                        StreamPlan plan, unsigned char* smem, int grid_, int block)
      : w(w_), wg(wg_), n(n_), slice(plan.slice), grid(grid_) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    mine = smem + (size_t)warp * G::kStages * G::kStageBytes;
    p8 = lane & 7;
    r8 = lane >> 3;
    row0 = warp * 16 + r8;
    rb = w_row_bytes<W>(k);
    align = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : 4;
    nst = (int)((rb + kSegBytes - 1) / kSegBytes);
    ks = (nst + plan.slice - 1) / plan.slice;
    tiles = (n + kStreamCols - 1) / kStreamCols;
    items = tiles * ks;
    walk = kPersist ? items * ((b + kStreamRows - 1) / kStreamRows) : items;
    p_item = block;
    p_st = block < walk ? (kPersist ? block % items : block) % ks * plan.slice : 0;
    issued = 0;
  }

  __device__ __forceinline__ void produce() {
    if (p_item < walk) {
      const int it = kPersist ? p_item % items : p_item;
      const unsigned dst0 = smem_addr(mine + (size_t)(issued % G::kStages) * G::kStageBytes);
      const int row = it / ks * kStreamCols + row0, kb = p_st * kSegBytes + 16 * p8;
      const int tail = (int)min(max((long long)rb - kb, 0ll), 16ll);
      const size_t at = (size_t)row * rb + kb;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int valid = row + 4 * i < n ? tail : 0;
        const size_t off = at + (size_t)(4 * i) * rb;
        copy_piece(dst0 + piece_offset<W>(r8 + 4 * i, p8), w + off, w, valid, align);
        if constexpr (kGated)
          copy_piece(dst0 + kWarpStage + piece_offset<W>(r8 + 4 * i, p8), wg + off, wg, valid, align);
      }
      step(it);
    }
    cp_commit();
    ++issued;
  }

  // the walk's next stage after one of item `it`
  __device__ __forceinline__ void step(int it) {
    if (++p_st == min((it % ks + 1) * slice, nst)) {
      p_item += grid;
      p_st = (kPersist ? p_item % items : p_item) % ks * slice;
    }
  }

  // the first stages, before anything else the phase does
  __device__ __forceinline__ void prologue() {
    for (int s = 0; s < G::kStages - 1; ++s) produce();
  }

  // the state prologue() leaves, where another copy of this ring issued the
  // stages (K11: before a grid barrier, so that no state lives across it)
  __device__ __forceinline__ void resume() {
    for (int s = 0; s < G::kStages - 1; ++s) {
      if (p_item < walk) step(kPersist ? p_item % items : p_item);
      ++issued;
    }
  }
};

// fp32 partials of one pass of rows of a deferred split (float4s): W's,
// then Wg's, for up to b rows a pass
__device__ __forceinline__ size_t stream_pass_parts(int b, int tiles, int ks, bool gated) {
  const int nts = ((b < kStreamRows ? b : kStreamRows) + 7) / 8;
  return (size_t)(gated ? 2 : 1) * ks * tiles * kWarps * nts * 32;
}

// The body's consumer, after `ring`'s prologue: the rows' statistics, then
// the items as `ring` walks them, block `block` of a grid of `grid` blocks.
// x (b <= 64 rows of k, X: bf16, or fp32 in K11), out (b, n); X, R: the input
// rows' and the residual's types; kCg: they are read through L2 alone
// (rows_gemv.cuh, the top). kPersist (K11's phases): any b, in passes of 64
// rows over the same items, the statistics taken at each pass's first item,
// a deferred split's partials kept per pass (stream_pass_parts apart).
template <typename W, typename OutT, bool kGated, int kAct, typename X, typename R, bool kCg, int kMaxNt,
          bool kPersist>
__device__ __forceinline__ void stream_consume(
    StreamRing<W, kGated, kMaxNt, kPersist>& ring, const X* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s,
    const __nv_bfloat16* __restrict__ ln_b, float eps, int norm, Epilogue<__nv_bfloat16, R> ep,
    OutT* __restrict__ out, int b, int n, int k, StreamPlan plan, StreamSplit split, unsigned char* smem, int grid,
    int block) {
  using G = Geometry<kMaxNt, kGated>;
  constexpr int kStages = G::kStages, kStageBytes = G::kStageBytes, kHBytes = G::kHBytes;
  constexpr int kSc = seg_chunks<W>();
  constexpr bool kScaled = !std::is_same<W, __nv_bfloat16>::value;
  uint4* hf = reinterpret_cast<uint4*>(smem + G::kRingBytes);
  float* mean = reinterpret_cast<float*>(smem + G::kRingBytes + kHBytes);
  float* inv = mean + kStreamRows;
  int* last = reinterpret_cast<int*>(inv + kStreamRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;

  const int nst = ring.nst, nchunks = (k + 31) / 32;
  const int ks = ring.ks, tiles = ring.tiles, items = ring.items;
  // K11: the pass of rows of the block's first item, and its first row
  int pass = kPersist && block < ring.walk ? block / items : 0, r0 = pass * kStreamRows;
  int rows = kPersist ? min(kStreamRows, b - r0) : b, nts = (rows + 7) / 8;
  int hst = kHBytes / (nts * 512 * kSc);         // stages of h a slice of it holds
  const unsigned char* my_ring = ring.mine;

  // the statistics, while the first stages land (K11, past 64 rows: a later pass's at its first item)
  if (ln_s != nullptr && (!kPersist || block < ring.walk))
    stream_stats<kMaxNt == 1 ? 8 : 4, kCg>(x + (size_t)r0 * k, eps, norm, rows, k, mean, inv);

  int consumed = 0;
  for (int v = block; v < ring.walk; v += grid) {
    int item = v;
    if constexpr (kPersist) {
      const int ps = v / items;
      item = v - ps * items;
      if (ps != pass) {  // uniform across the block
        pass = ps;
        r0 = ps * kStreamRows;
        rows = min(kStreamRows, b - r0);
        nts = (rows + 7) / 8;
        hst = kHBytes / (nts * 512 * kSc);
        if (ln_s != nullptr) stream_stats<1, kCg>(x + (size_t)r0 * k, eps, norm, rows, k, mean, inv);
      }
    }
    const int tile = item / ks, sl = item % ks;
    const int st0 = sl * plan.slice, st1 = min(st0 + plan.slice, nst);
    const int col0 = tile * kStreamCols + warp * 16;
    const bool live = col0 < n;  // uniform across the warp
    float acc[8][4], gacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = gacc[j][i] = 0.f;

    for (int hs = st0; hs < st1; hs += hst) {
      const int he = min(hs + hst, st1);
      __syncthreads();  // the statistics are written; the last h slice is read
      stream_stage_h<kGated ? 1 : 2, kCg>(x + (size_t)r0 * k, ln_s, ln_b, mean, inv, rows, k, nts, hs * kSc,
                                          (he - hs) * kSc, hf);
      __syncthreads();
      for (int st = hs; st < he; ++st) {
        ring.produce();
        cp_wait<kStages - 1>();  // this warp's stage `consumed` has landed
        __syncwarp();
        if (live) {
          const unsigned char* stage = my_ring + (size_t)(consumed % kStages) * kStageBytes;
          const uint4* hb = hf + (size_t)(st - hs) * kSc * nts * 32 + lane;
          const int chunks = min(kSc, nchunks - st * kSc);
          if constexpr (kMaxNt == 1) {
            stage_products<1, W, kGated>(acc, gacc, stage, hb, nts, chunks, lane);
          } else {
            if (nts == 1) stage_products<1, W, kGated>(acc, gacc, stage, hb, nts, chunks, lane);
            else if (nts == 2) stage_products<2, W, kGated>(acc, gacc, stage, hb, nts, chunks, lane);
            else if (nts <= 4) stage_products<4, W, kGated>(acc, gacc, stage, hb, nts, chunks, lane);
            else stage_products<8, W, kGated>(acc, gacc, stage, hb, nts, chunks, lane);
          }
        }
        __syncwarp();  // every lane is done with the slot before it is refilled
        ++consumed;
      }
    }

    bool emit = true;
    if (ks > 1) {  // this slice's partials, then the tile's last arrival adds them all in slice order
      float4* part = reinterpret_cast<float4*>(split.scratch) +
                     (kPersist ? pass * stream_pass_parts(b, tiles, ks, kGated) : 0);
      const size_t per_item = (size_t)kWarps * nts * 32, gofs = (size_t)ks * tiles * per_item;
      const size_t base = ((size_t)sl * tiles + tile) * per_item + (size_t)warp * nts * 32 + lane;
      if (live) {
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j) {
          if (j < nts) {
            part[base + j * 32] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
            if constexpr (kGated) part[gofs + base + j * 32] = make_float4(gacc[j][0], gacc[j][1], gacc[j][2], gacc[j][3]);
          }
        }
      }
      if (split.defer) continue;  // gemv_stream_reduce_kernel (K11: stream_reduce_pass) adds the slices
      __syncthreads();  // the block's partials are written; one fence orders them before its count
      if (threadIdx.x == 0) {
        __threadfence();
        *last = atomicAdd(split.counters + tile, 1) == ks - 1;
        if (*last) __threadfence();  // every slice's partials, seen before they are read
      }
      __syncthreads();
      emit = *last != 0;
      if (emit) {
        if (live) {
          const size_t b0 = (size_t)tile * per_item + (size_t)warp * nts * 32 + lane;
#pragma unroll
          for (int j = 0; j < kMaxNt; ++j) {
            if (j < nts) {
              constexpr int kFly = kMaxNt == 1 ? 8 : 4;
              for (int s0 = 0; s0 < ks; s0 += kFly) {  // kFly slices' loads in flight, added in slice order
                float4 v[kFly], u[kFly];
#pragma unroll
                for (int q = 0; q < kFly; ++q) {
                  if (s0 + q >= ks) break;
                  const size_t at = (size_t)(s0 + q) * tiles * per_item + b0 + j * 32;
                  v[q] = __ldcg(part + at);
                  if constexpr (kGated) u[q] = __ldcg(part + gofs + at);
                }
#pragma unroll
                for (int q = 0; q < kFly; ++q) {
                  if (s0 + q >= ks) break;
                  const bool first = s0 + q == 0;
                  acc[j][0] = first ? v[q].x : __fadd_rn(acc[j][0], v[q].x);
                  acc[j][1] = first ? v[q].y : __fadd_rn(acc[j][1], v[q].y);
                  acc[j][2] = first ? v[q].z : __fadd_rn(acc[j][2], v[q].z);
                  acc[j][3] = first ? v[q].w : __fadd_rn(acc[j][3], v[q].w);
                  if constexpr (kGated) {
                    gacc[j][0] = first ? u[q].x : __fadd_rn(gacc[j][0], u[q].x);
                    gacc[j][1] = first ? u[q].y : __fadd_rn(gacc[j][1], u[q].y);
                    gacc[j][2] = first ? u[q].z : __fadd_rn(gacc[j][2], u[q].z);
                    gacc[j][3] = first ? u[q].w : __fadd_rn(gacc[j][3], u[q].w);
                  }
                }
              }
            }
          }
        }
        if (threadIdx.x == 0) split.counters[tile] = 0;  // for the next launch
      }
    }
    if (emit && live) {
      // acc[j][0..1]: column col0 + g, rows 8j + 2t, + 1; acc[j][2..3]: column + 8
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j) {
        if (j < nts) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = col0 + g + (i >> 1) * 8, r = 8 * j + 2 * t4 + (i & 1);
            if (col < n && r < rows)
              out[(size_t)(r0 + r) * n + col] = from_f32<OutT>(
                  epilogue<kScaled, kGated, kAct, true>(acc[j][i], gacc[j][i], ep, r0 + r, col, n));
          }
        }
      }
    }
  }
  cp_wait<0>();
}

// The body of one launch, for block `block` of a grid of `grid` blocks (a
// kernel that carries other blocks too passes its own count): the ring's
// first stages fly while the statistics are taken, then the items. x (b <=
// 64 rows of k), out (b, n); X, R, kCg as stream_consume's.
template <typename W, typename OutT, bool kGated, int kAct, typename X = __nv_bfloat16,
          typename R = __nv_bfloat16, bool kCg = false, int kMaxNt = 8>
__device__ __forceinline__ void stream_body(
    const X* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s, const __nv_bfloat16* __restrict__ ln_b,
    float eps, int norm, const unsigned char* __restrict__ w, const unsigned char* __restrict__ wg,
    Epilogue<__nv_bfloat16, R> ep, OutT* __restrict__ out, int b, int n, int k, StreamPlan plan, StreamSplit split,
    unsigned char* smem, int grid, int block) {
  StreamRing<W, kGated, kMaxNt> ring(w, wg, n, k, b, plan, smem, grid, block);
  ring.prologue();
  stream_consume<W, OutT, kGated, kAct, X, R, kCg, kMaxNt, false>(ring, x, ln_s, ln_b, eps, norm, ep, out, b, n, k,
                                                                   plan, split, smem, grid, block);
}

// OutT: bf16 (K1, K2, the out-projections of K3 and K6) or fp32 (K3's q/k/v)
template <typename W, bool kGated, int kAct, int kMaxNt, typename OutT = __nv_bfloat16>
__global__ void __launch_bounds__(kThreads, 1) gemv_stream_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s,
    const __nv_bfloat16* __restrict__ ln_b, float eps, int norm, const unsigned char* __restrict__ w,
    const unsigned char* __restrict__ wg, Epilogue<__nv_bfloat16> ep, OutT* __restrict__ out, int b, int n,
    int k, StreamPlan plan, StreamSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_body<W, OutT, kGated, kAct, __nv_bfloat16, __nv_bfloat16, false, kMaxNt>(
      x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, plan, split, smem, gridDim.x, blockIdx.x);
}

// A deferred split's end for output i of a pass of b rows (one lane's float4
// of one n-tile of one warp's 16 columns of a tile): the slices' partials
// added in slice order (the body's last-block order, so the bits are the
// same) and the epilogue run on its four outputs. kCg: the partials were
// written by other blocks of the same launch (K11), read through L2 alone.
template <bool kScaled, bool kGated, int kAct, typename OutT, typename R, bool kCg>
__device__ __forceinline__ void stream_reduce_one(size_t i, const float* __restrict__ scratch,
                                                  const Epilogue<__nv_bfloat16, R>& ep, OutT* __restrict__ out, int b,
                                                  int n, int tiles, int ks, int nts) {
  const size_t per_item = (size_t)kWarps * nts * 32, gofs = (size_t)ks * tiles * per_item;
  const int tile = (int)(i / per_item), rem = (int)(i % per_item);
  const int warp = rem / (nts * 32), j = rem / 32 % nts, lane = rem % 32, g = lane >> 2, t4 = lane & 3;
  const float4* part = reinterpret_cast<const float4*>(scratch);
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, gacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < ks; s0 += 8) {  // eight slices' loads in flight, added in slice order
    float4 v[8], u[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (s0 + q >= ks) break;
      const size_t at = (size_t)(s0 + q) * tiles * per_item + i;
      if constexpr (kCg) {
        v[q] = __ldcg(part + at);
        if constexpr (kGated) u[q] = __ldcg(part + gofs + at);
      } else {
        v[q] = part[at];
        if constexpr (kGated) u[q] = part[gofs + at];
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (s0 + q >= ks) break;
      const bool first = s0 + q == 0;
      acc[0] = first ? v[q].x : __fadd_rn(acc[0], v[q].x);
      acc[1] = first ? v[q].y : __fadd_rn(acc[1], v[q].y);
      acc[2] = first ? v[q].z : __fadd_rn(acc[2], v[q].z);
      acc[3] = first ? v[q].w : __fadd_rn(acc[3], v[q].w);
      if constexpr (kGated) {
        gacc[0] = first ? u[q].x : __fadd_rn(gacc[0], u[q].x);
        gacc[1] = first ? u[q].y : __fadd_rn(gacc[1], u[q].y);
        gacc[2] = first ? u[q].z : __fadd_rn(gacc[2], u[q].z);
        gacc[3] = first ? u[q].w : __fadd_rn(gacc[3], u[q].w);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = tile * kStreamCols + warp * 16 + g + (q >> 1) * 8, r = 8 * j + 2 * t4 + (q & 1);
    if (col < n && r < b)
      out[(size_t)r * n + col] = from_f32<OutT>(epilogue<kScaled, kGated, kAct, true>(acc[q], gacc[q], ep, r, col, n));
  }
}

// The separate launches' deferred split: a thread per four outputs. Many
// blocks share the reads a last block would make alone, the cost at B 64.
template <bool kScaled, bool kGated, int kAct, typename OutT = __nv_bfloat16>
__global__ void __launch_bounds__(256) gemv_stream_reduce_kernel(const float* __restrict__ scratch,
                                                           Epilogue<__nv_bfloat16> ep, OutT* __restrict__ out,
                                                           int b, int n, int tiles, int ks, int nts) {
  const size_t per_item = (size_t)kWarps * nts * 32;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= tiles * per_item) return;
  stream_reduce_one<kScaled, kGated, kAct, OutT, __nv_bfloat16, false>(i, scratch, ep, out, b, n, tiles, ks, nts);
}

// K11's deferred split of one phase (stream_consume<kPersist> with
// split.defer, after a grid barrier): every pass of 64 rows of b, its
// outputs strided over the whole grid, in the separate launches' order.
template <typename W, bool kGated, int kAct, typename OutT, typename R>
__device__ __forceinline__ void stream_reduce_pass(const float* scratch, const Epilogue<__nv_bfloat16, R>& ep,
                                                   OutT* out, int b, int n, int k, StreamPlan plan) {
  const int nst = (int)((w_row_bytes<W>(k) + kSegBytes - 1) / kSegBytes);
  const int ks = (nst + plan.slice - 1) / plan.slice, tiles = (n + kStreamCols - 1) / kStreamCols;
  for (int r0 = 0, ps = 0; r0 < b; r0 += kStreamRows, ++ps) {
    const int rows = min(kStreamRows, b - r0), nts = (rows + 7) / 8;
    Epilogue<__nv_bfloat16, R> ep_pass = ep;
    if (ep.residual != nullptr) ep_pass.residual += (size_t)r0 * n;
    const float* part = scratch + 4 * ps * stream_pass_parts(b, tiles, ks, kGated);
    const size_t count = (size_t)tiles * kWarps * nts * 32;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += (size_t)gridDim.x * blockDim.x)
      stream_reduce_one<!std::is_same<W, __nv_bfloat16>::value, kGated, kAct, OutT, R, true>(
          i, part, ep_pass, out + (size_t)r0 * n, rows, n, tiles, ks, nts);
  }
}

// Launches gemv_stream_reduce_kernel after a deferred split of b rows (<= 64)
template <bool kScaled, bool kGated, int kAct, typename OutT = __nv_bfloat16>
cudaError_t launch_stream_reduce(const StreamSplit& split, Epilogue<__nv_bfloat16> ep, OutT* out, int b, int n,
                                 int tiles, int ks, cudaStream_t st) {
  const int nts = (b + 7) / 8;
  const long long threads = (long long)tiles * kWarps * nts * 32;
  gemv_stream_reduce_kernel<kScaled, kGated, kAct, OutT><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      split.scratch, ep, out, b, n, tiles, ks, nts);
  return cudaGetLastError();
}

// The K slices of `plan` for K of weight type W
template <typename W>
__host__ __device__ int stream_slices(const StreamPlan& plan, int k) {
  const long long nst = ((long long)w_row_bytes<W>(k) + kSegBytes - 1) / kSegBytes;
  return (int)((nst + plan.slice - 1) / plan.slice);
}

// Whether `plan` and `split` can run (N, K) of weight type W: stages per
// slice and blocks at least 1, and a split K with its scratch and a count per
// column tile.
template <typename W>
bool stream_plan_ok(const StreamPlan& plan, const StreamSplit& split, int n, int k) {
  if (plan.slice < 1 || plan.blocks < 1 || n < 1 || k < kVec || k % kVec != 0) return false;
  const long long nst = ((long long)w_row_bytes<W>(k) + kSegBytes - 1) / kSegBytes;
  const long long tiles = ((long long)n + kStreamCols - 1) / kStreamCols;
  if ((nst + plan.slice - 1) / plan.slice > 1)
    return split.scratch != nullptr && split.counters != nullptr && split.ncount >= tiles;
  return true;
}

// One launch per pass of 64 rows: out (b, n) = epilogue(h @ W^T), as
// launch_gemv's, from bf16 rows on this body, out in OutT.
template <typename W, bool kGated, int kAct, typename OutT = __nv_bfloat16>
cudaError_t launch_stream_typed(const __nv_bfloat16* x, const __nv_bfloat16* ln_s, const __nv_bfloat16* ln_b,
                                float eps, int norm, const void* w, const void* wg, Epilogue<__nv_bfloat16> ep,
                                OutT* out, int b, int n, int k, StreamPlan plan, StreamSplit split, cudaStream_t st) {
  if (b <= 8) {  // the decode batch: the one-n-tile instance
    auto kern = gemv_stream_kernel<W, kGated, kAct, 1, OutT>;
    constexpr size_t smem = Geometry<1, kGated>::kSmem;
    static size_t smem_set = 48 * 1024;
    cudaError_t e = allow_smem(kern, smem, smem_set);
    if (e != cudaSuccess) return e;
    kern<<<plan.blocks, kThreads, smem, st>>>(x, ln_s, ln_b, eps, norm, static_cast<const unsigned char*>(w),
                                             static_cast<const unsigned char*>(wg), ep, out, b, n, k, plan, split);
    return cudaGetLastError();
  }
  auto kern = gemv_stream_kernel<W, kGated, kAct, 8, OutT>;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = allow_smem(kern, kStreamSmem, smem_set);
  if (e != cudaSuccess) return e;
  const int ks = stream_slices<W>(plan, k), tiles = (n + kStreamCols - 1) / kStreamCols;
  StreamSplit deferred = split;
  deferred.defer = ks > 1;
  for (int r0 = 0; r0 < b; r0 += kStreamRows) {
    Epilogue<__nv_bfloat16> ep_pass = ep;
    if (ep.residual != nullptr) ep_pass.residual += (size_t)r0 * n;
    const int rows = min(kStreamRows, b - r0);
    kern<<<plan.blocks, kThreads, kStreamSmem, st>>>(
        x + (size_t)r0 * k, ln_s, ln_b, eps, norm, static_cast<const unsigned char*>(w),
        static_cast<const unsigned char*>(wg), ep_pass, out + (size_t)r0 * n, rows, n, k, plan, deferred);
    e = cudaGetLastError();
    if (e == cudaSuccess && deferred.defer)
      e = launch_stream_reduce<!std::is_same<W, __nv_bfloat16>::value, kGated, kAct, OutT>(
          deferred, ep_pass, out + (size_t)r0 * n, rows, n, tiles, ks, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename W, bool kGated>
cudaError_t launch_stream(const __nv_bfloat16* x, const __nv_bfloat16* ln_s, const __nv_bfloat16* ln_b, float eps,
                          int norm, const void* w, const void* wg, Epilogue<__nv_bfloat16> ep, __nv_bfloat16* out,
                          int b, int n, int k, StreamPlan plan, StreamSplit split, cudaStream_t st) {
  if (b < 1 || (kGated && wg == nullptr) || !stream_plan_ok<W>(plan, split, n, k)) return cudaErrorInvalidValue;
  auto typed = [&](auto act) {
    return launch_stream_typed<W, kGated, decltype(act)::value>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k,
                                                                 plan, split, st);
  };
  switch (ep.act) {
    case kNone:
    case kGelu: return typed(std::integral_constant<int, kActBase>{});
    case kGeluNew: return typed(std::integral_constant<int, kGeluNew>{});
    case kRelu: return typed(std::integral_constant<int, kRelu>{});
    case kQuickGelu: return typed(std::integral_constant<int, kQuickGelu>{});
    case kSilu: return typed(std::integral_constant<int, kSilu>{});
    default: return cudaErrorInvalidValue;
  }
}

// The form of K3's and K6's projections on this body: no gated weight, no
// activation, a LayerNorm or none, out in OutT (K3's q/k/v fp32, the
// out-projections bf16). Compiles the two instances (B <= 8, any B) of the
// weight type and nothing else.
template <typename W, typename OutT>
cudaError_t launch_stream_projection_typed(const __nv_bfloat16* x, const __nv_bfloat16* ln_s,
                                           const __nv_bfloat16* ln_b, float eps, const void* w,
                                           Epilogue<__nv_bfloat16> ep, OutT* out, int b, int n, int k,
                                           StreamPlan plan, StreamSplit split, cudaStream_t st) {
  if (b < 1 || ep.act != kNone || !stream_plan_ok<W>(plan, split, n, k)) return cudaErrorInvalidValue;
  return launch_stream_typed<W, false, kActBase, OutT>(x, ln_s, ln_b, eps, kLayerNorm, w, nullptr, ep, out, b, n, k,
                                                       plan, split, st);
}

// launch_stream_projection_typed on the weight type code (0 bf16, 1 int8,
// 2 packed int4): every bf16 row GEMV of K3 and K6
template <typename OutT>
cudaError_t launch_stream_projection(int wtype, const __nv_bfloat16* x, const __nv_bfloat16* ln_s,
                                     const __nv_bfloat16* ln_b, float eps, const void* w, Epilogue<__nv_bfloat16> ep,
                                     OutT* out, int b, int n, int k, StreamPlan plan, StreamSplit split,
                                     cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  switch (wtype) {
    case 0: return launch_stream_projection_typed<bf16, OutT>(x, ln_s, ln_b, eps, w, ep, out, b, n, k, plan, split, st);
    case 1: return launch_stream_projection_typed<int8_t, OutT>(x, ln_s, ln_b, eps, w, ep, out, b, n, k, plan, split, st);
    case 2: return launch_stream_projection_typed<Int4, OutT>(x, ln_s, ln_b, eps, w, ep, out, b, n, k, plan, split, st);
    default: return cudaErrorInvalidValue;
  }
}

// launch_gemv_norm's form for bf16 on this body: the weight type code (0
// bf16, 1 int8, 2 packed int4), the norm kind, any activation, gated with wg;
// every bf16 row GEMV of K1 and K2. A template, so that only a source that
// calls it compiles its 30 kernels.
template <typename T>
cudaError_t launch_gemv_stream(int wtype, const T* x, const T* ln_s, const T* ln_b, float eps, int norm,
                               const void* w, const void* wg, Epilogue<T> ep, T* out, int b, int n, int k,
                               StreamPlan plan, StreamSplit split, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  static_assert(std::is_same<T, bf16>::value, "the weight-streaming body takes bf16 rows");
  if (norm != kLayerNorm && norm != kRmsNorm) return cudaErrorInvalidValue;
  switch (wtype * 2 + (wg != nullptr)) {
    case 0: return launch_stream<bf16, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, plan, split, st);
    case 1: return launch_stream<bf16, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, plan, split, st);
    case 2: return launch_stream<int8_t, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, plan, split, st);
    case 3: return launch_stream<int8_t, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, plan, split, st);
    case 4: return launch_stream<Int4, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, plan, split, st);
    case 5: return launch_stream<Int4, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, plan, split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rows
