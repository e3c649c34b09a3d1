// K9 ViT attention for Hopper (sm_90a): bidirectional whole-sequence
// attention of every (image, head) instance, fp32 softmax, the scores kept
// on chip.
//
//   replaces open_flamingo_tpu/ops/vit_attention.py `vit_attention` (kernel
//   `_vit_attn_kernel` via `_vit_attention_fwd_impl`).
//
// Semantics, the TPU kernel's: q is multiplied by `scale` in fp32 and
// rounded to q's dtype; scores q.k^T in fp32; keys at or past S masked
// before the max; P = exp(s - max) normalised by its row sum in fp32, then
// rounded to v's dtype; P.V summed in fp32 and rounded to the output dtype.
// The whole key row is on chip (S <= kMaxS), so the max and the sum are
// taken over it before P is rounded: no online softmax, whose deferred
// normalisation would round P differently in bf16.
//
// Layout. q, k, v and out are read and written through (batch, head, row)
// element strides with Dh contiguous: the ViT passes the projections'
// (B, S, H*Dh) outputs as (B, S, H, Dh) views and gets (B, S, H*Dh) back,
// with no head transpose and no pad copy around the launch (what cost the
// TPU kernel its win); a (BH, S, Dh) tensor is batch BH with one head.
//
// Bound. At ViT-L/14 (S 257, Dh 64) an instance's q/k/v/out are 132 KB in
// bf16 and its attention 17 MFLOP: ~130 FLOP per byte, under the H100's
// ~295, so the bytes over 3.35 TB/s are the floor (B 8: 16.8 MB, 0.0050
// ms), with the FLOPs over 989 TFLOP/s close behind. The einsum route
// writes the fp32 score matrix (S x S per instance) to device memory and
// reads it back several times; here it never leaves registers.
//
// * bf16: a persistent kernel (`vit_attn_bf16`), one block per SM, each
//   walking over (image, head) instances blockIdx.x, + gridDim.x, ...: no
//   wave tail at any B. A block is two consumer warpgroups and a producer
//   warpgroup (384 threads) that gives its registers to the consumers by
//   `setmaxnreg` (232 a consumer thread, 40 a producer thread): a
//   consumer's scores alone take 136. Without it the cap is 168 (three
//   warps on one SM sub-partition's 16,384 registers), which spilled 2-3 KB
//   a thread and serialized the products.
//   - One producer thread issues every load by TMA (cp.async.bulk.tensor
//     over a 4-D map (Dh, rows, heads, batch) with the operand's strides,
//     in the swizzle of Dh's width: 128 bytes at Dh 64, 64 at 32, 32 at
//     16; rows past the tensor zero-filled): an instance's K and V ONCE,
//     all kMaxS rows in two boxes each, into a ring of two instance stages
//     (K, the first q tiles, then V), so instance i+1's K and V land while
//     i computes; q in 64-row tiles into two slots per consumer. Completion
//     is counted on `mbarrier`s (full: the bytes; empty: the consumers'
//     arrivals).
//   - The instance's 64-row query tiles (S 257: 5) go to the consumers in
//     turns, continuing across instances, so the two stay balanced. A
//     consumer loads its q tile's A fragments from shared memory
//     (`ldmatrix` on the swizzled tile; K9 scales them in fp32 and rounds
//     to bf16 in registers), then Q.K^T as `wgmma` over all kMaxS keys,
//     whatever S (four m64n64k16 chunks and one m64n16k16 tile a k-step, K
//     from shared memory, K-major), in one straight run: ptxas waits for
//     each product before the next when a branch parts them (C7511). The
//     fp32 scores of its 64 rows stay in the accumulators (136 a thread).
//     The accumulator gives each row to one quad of lanes, as `mma.sync`
//     does: row max and sum are quad shuffles (keys at or past S masked
//     first: at S > 256 only in the last 16-key tile); exp as 2^(x log2 e)
//     on the MUFU unit; P, normalised (times the row's reciprocal) and
//     rounded to bf16, is already the register A operand of P.V, `wgmma`
//     m64nDh k16 over the 17 16-key steps with V read MN-major from shared
//     memory (the transpose bit). A warp whose 16 rows all lie past S
//     (S 257's fifth tile: three of four) skips its softmax and multiplies
//     zeros. The output goes to bf16, into a swizzled tile in shared
//     memory, and out by a TMA store that drops rows past S.
//   - The fifth tile at S 257 holds one real row: a 64-row `wgmma` tile
//     costs its products in full (20% more tensor work than 257 rows), but
//     its skipped softmax is most of a tile's time; a second, smaller tile
//     shape would double the kernel's instances.
//   - Every (instance, tile) runs the same instructions on the same data
//     whichever block and warpgroup takes it, so a row's sums do not depend
//     on the launch's size or its schedule, and two calls give the same
//     bits. `wgmma` stays on paths ptxas sees as warp-uniform (the roles
//     and tiles branch on warp indices broadcast from lane 0; C7518).
//   - What the compiler must not see: values hoisted out of the tile loop
//     (descriptors, lane-derived addresses) and registers written between
//     the fence and the products (zeroed accumulators, P zeroed in a
//     branch) cost registers the scores need; `rows_desc`, the per-tile
//     lane and the fences keep them where they are used.
// * fp32: CUDA cores (no TF32, which keeps ~3 digits), one block per
//   (instance, block of query rows): each warp takes its block's query rows
//   one at a time, lane j scores keys j, j + 32, ... from K in shared
//   memory (rows padded by one word: conflict-free), the warp reduces max
//   and sum by shuffles, writes P to shared memory, and each lane sums P.V
//   for its columns of the row.
//
// K8 flat_vit_attention (`flat_vit_attention_fwd`, its own entry point):
//
//   replaces open_flamingo_tpu/ops/vit_attention.py `flat_vit_attention`
//   (kernel `_flat_attn_kernel`), the absorbed ViT's attention glue.
//
// The same kernels as instances of their own (kFlat), on the flat
// (B, S_pad, H*Dh) workspace of the absorbed ViT, read through the same
// (batch, head, row) strides: every one of the S_pad query rows is computed
// (pad rows too, as the TPU kernel does: finite values over the real keys),
// keys at or past s_real are masked, and the math is the TPU kernel's fp32:
// q and k exact (bf16 products are exact in fp32), scores q.k^T in fp32
// times `scale` after the product, P = exp(s - max) / sum in fp32, P.V in
// fp32, one rounding of the output. In bf16 P goes through the tensor cores
// as a hi/lo pair of bf16 (hi = bf16(P), lo = bf16(P - hi): P within 2^-17
// of its value, exact products, fp32 sums), two products per k-step where
// K9 rounds P once. Bound at OF-3B's B' 8 (S_pad 264, s_real 257, 16 heads
// of Dh 64): 17.3 MB of q/k/v/out over 3.35 TB/s, 0.0052 ms, above 2.2
// GFLOP over 989 TFLOP/s.

#include <cuda.h>   // CUtensorMap and cuTensorMapEncodeTiled's types; the function is the driver's entry point
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "gmma.cuh"
#include "mma_frag.cuh"

namespace {

using namespace ::gmma;

constexpr int kMaxS = 272;                 // keys on chip per row: 17 tiles of 16
constexpr int kKeyTiles = kMaxS / 16;
constexpr int kMaxWarps = 8;               // fp32 blocks
constexpr int kMaxD = 64;

struct Strides {
  long long b, h, s;  // element strides of batch, head and row; Dh contiguous
};

struct Operand {
  const void* p;
  Strides st;
};

// ---------------------------------------------------------------- bf16

constexpr int kGroups = 2;                        // consumer warpgroups
constexpr int kThreads = (kGroups + 1) * 128;     // and the producer's warpgroup
// registers a thread after `setmaxnreg`: the producer gives its own to the
// consumers (per SM sub-partition, one producer and two consumer warps:
// (40 + 2 * 232) * 32 of its 16,384)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kQRows = 64;                        // a consumer's tile of query rows: wgmma's M
constexpr int kStages = 2;                        // instances whose K and V are staged at once
constexpr int kQSlots = 2;                        // q tiles staged per consumer
constexpr int kBoxRows = kMaxS / 2;               // rows of a TMA box of K or V (at most 256): two a stage

// The shared memory of one block at Dh = D, from a 1,024-byte aligned base:
// rows of RB = 2D bytes, each buffer a whole number of swizzle atoms
template <int D>
struct Layout {
  static constexpr int RB = 2 * D;
  static constexpr int kv = kMaxS * RB;                          // one stage's K (or V)
  static constexpr int tile = kQRows * RB;                       // a q or output tile
  static constexpr int k_off = 0;
  static constexpr int v_off = kStages * kv;
  static constexpr int q_off = 2 * kStages * kv;                 // [group][slot]
  static constexpr int o_off = q_off + kGroups * kQSlots * tile;  // [group]
  static constexpr int bar_off = o_off + kGroups * tile;
  // barriers: K full [stage], V full [stage], K/V empty [stage], q full [group][slot], q empty [group][slot]
  static constexpr int kFullK = 0, kFullV = kStages, kEmptyKV = 2 * kStages, kFullQ = 3 * kStages,
                       kEmptyQ = kFullQ + kGroups * kQSlots, kBars = kEmptyQ + kGroups * kQSlots;
  static constexpr int bytes = bar_off + 8 * kBars + 1024;       // + the alignment of the base
};

// One launch's geometry, from the host (launch_bf16)
struct Plan {
  int nh;          // heads: instance i is (i / nh, i % nh)
  int instances;
  int s_q;         // query rows
  int keys;        // key rows (K9: s_q; K8: s_real)
  int q_tiles;     // ceil(s_q / 64)
  float scale;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(a), "r"(parity)
                 : "memory");
  } while (!done);
}

// a box of the 4-D map at (0, row, head, batch) into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int row, int h, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}
// a tile of shared memory to the box at (0, row, head, batch); rows past the tensor are dropped
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int row, int h, int b) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
               "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(0), "r"(row), "r"(h), "r"(b)
               : "memory");
}
// until the committed stores have read their shared memory (kRead) or completed
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

// The producer's one thread: every instance's K and V into the stage ring, the
// q tiles into their consumer's slots, in the order the consumers take them
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                       unsigned char* smem, uint64_t* bars, const Plan& p) {
  using L = Layout<D>;
  constexpr unsigned kv_bytes = kMaxS * L::RB;   // every stage holds kMaxS rows: zeros past the keys
  int n = 0;
  for (int inst = blockIdx.x; inst < p.instances; inst += gridDim.x, ++n) {
    const int b = inst / p.nh, h = inst % p.nh, s = n % kStages;
    if (n >= kStages) mbar_wait(&bars[L::kEmptyKV + s], (n / kStages - 1) & 1);
    // K first: the first q tiles' products need it; V after the first two q tiles
    mbar_expect_tx(&bars[L::kFullK + s], kv_bytes);
    for (int i = 0; i < 2; ++i)
      tma_load(smem + L::k_off + s * L::kv + i * kBoxRows * L::RB, tk, i * kBoxRows, h, b, &bars[L::kFullK + s]);
    const int v_at = p.q_tiles < 2 ? p.q_tiles : 2;
    for (int t = 0; t <= p.q_tiles; ++t) {
      if (t == v_at) {
        mbar_expect_tx(&bars[L::kFullV + s], kv_bytes);
        for (int i = 0; i < 2; ++i)
          tma_load(smem + L::v_off + s * L::kv + i * kBoxRows * L::RB, tv, i * kBoxRows, h, b, &bars[L::kFullV + s]);
      }
      if (t == p.q_tiles) break;
      const int item = n * p.q_tiles + t, g = item % kGroups, j = item / kGroups, q = g * kQSlots + j % kQSlots;
      if (j >= kQSlots) mbar_wait(&bars[L::kEmptyQ + q], (j / kQSlots - 1) & 1);
      mbar_expect_tx(&bars[L::kFullQ + q], L::tile);
      tma_load(smem + L::q_off + q * L::tile, tq, t * kQRows, h, b, &bars[L::kFullQ + q]);
    }
  }
}

// The A fragments of a consumer's q tile (its warp's 16 rows, D / 16
// k-steps) from the swizzled tile; K9 scales them in fp32 and rounds to bf16
template <int D, bool kFlat>
__device__ __forceinline__ void q_fragments(uint32_t (*qa)[4], const unsigned char* qs, int wi, int lane,
                                            float scale) {
  constexpr int RB = 2 * D;
  const int r = wi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(qa[kk], qs + swizzle<RB>(r * RB + (kk * 16 + (lane >> 4) * 8) * 2));
    if constexpr (!kFlat) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][i]));
        qa[kk][i] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
  }
}

// The descriptor of a stage's K or V rows from row 0, made here and opaque
// to the compiler: each product adds its rows' offset to it in place, where
// descriptors hoisted out of the tile loop (two registers each, 37 of them)
// would crowd out the scores
template <int RB>
__device__ __forceinline__ uint64_t rows_desc(const unsigned char* rows) {
  uint64_t d = gmma_desc_rows<RB>(rows);
  asm volatile("" : "+l"(d));
  return d;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A consumer warpgroup: its share of every instance's query tiles
template <int D, bool kFlat>
__device__ __forceinline__ void consume(const CUtensorMap* to, unsigned char* smem, uint64_t* bars, const Plan& p,
                                        int g, int wi) {
  using L = Layout<D>;
  constexpr int RB = L::RB, DK = D / 16, DN = D / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  const bool lead = threadIdx.x % 128 == 0;
  // exp(x) as 2^(x log2 e); K8's scale multiplies its fp32 scores here (> 0: the max is the scaled row's)
  const float sl = kFlat ? p.scale * kLog2e : kLog2e;
  unsigned char* os = smem + L::o_off + g * L::tile;
  int j = 0, n = 0;
  for (int inst = blockIdx.x; inst < p.instances; inst += gridDim.x, ++n) {
    const int b = inst / p.nh, h = inst % p.nh, s = n % kStages;
    const unsigned kv_parity = (n / kStages) & 1;
    const unsigned char* ks = smem + L::k_off + s * L::kv;
    const unsigned char* vs = smem + L::v_off + s * L::kv;
    for (int t = 0; t < p.q_tiles; ++t) {
      if ((n * p.q_tiles + t) % kGroups != g) continue;
      // the lane made anew for each tile: what derives from it (fragment,
      // mask and store addresses) is computed where it is used, not hoisted
      // out of the loop into registers the scores need
      int lane = threadIdx.x % 32;
      asm volatile("" : "+r"(lane));
      const int qd = lane / 4, t4 = lane % 4;
      const int q = g * kQSlots + j % kQSlots;
      mbar_wait(&bars[L::kFullQ + q], (j / kQSlots) & 1);
      uint32_t qa[DK][4];
      q_fragments<D, kFlat>(qa, smem + L::q_off + q * L::tile, wi, lane, p.scale);
      mbar_arrive(&bars[L::kEmptyQ + q]);
      ++j;

      // scores: n8 tile jj (keys 8jj..8jj+7) in sc[4jj..4jj+3], rows qd and qd + 8 of the warp's 16; the
      // first product of each tile starts its sums (nothing written to them before the fence)
      float sc[kKeyTiles * 8];
      mbar_wait(&bars[L::kFullK + s], kv_parity);
      const uint64_t dk = rows_desc<RB>(ks);   // + 16 bytes per unit: rows at RB, k-steps at 32 bytes
      // all kMaxS keys whatever S, in one straight run of products: a branch
      // between two of them makes ptxas wait for each before the next (C7511)
      fence_regs<DK * 4>(&qa[0][0]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kKeyTiles / 4; ++c) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          wgmma_rs_bf16<64, 0>(sc + 32 * c, qa[kk], dk + (c * 64 * RB + kk * 32) / 16, kk > 0);
      }
      static_assert(kKeyTiles % 4 == 1, "the keys as 64-key chunks and one 16-key tile");
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        wgmma_rs_bf16<16, 0>(sc + 8 * (kKeyTiles - 1), qa[kk], dk + ((kKeyTiles - 1) * 16 * RB + kk * 32) / 16,
                             kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kKeyTiles * 8>(sc);
      fence_regs<DK * 4>(&qa[0][0]);

      // P of the warp's rows, as the A fragments of P.V: k-step u's from n8
      // tiles 2u and 2u + 1. A warp whose rows all lie past S (warp-uniform)
      // skips the softmax and keeps its raw scores (finite: its q rows are
      // zeros) with reciprocals 0: P zeros, its rows dropped by the store.
      float ra = 0.f, rb = 0.f;
      if (t * kQRows + wi * 16 < p.s_q) {
        // column 8jj + e is a key where 8jj + e < keys; at S > 256 only the last 16-key tile holds others
        const int lim = p.keys - 2 * t4;
#pragma unroll
        for (int jj = 0; jj < 2 * kKeyTiles; ++jj) {
          if (p.keys <= kMaxS - 16 || jj >= 2 * kKeyTiles - 2) {
            float* c = sc + 4 * jj;
            if (jj * 8 >= lim) c[0] = c[2] = -INFINITY;
            if (jj * 8 + 1 >= lim) c[1] = c[3] = -INFINITY;
          }
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 2 * kKeyTiles; ++jj) {
          const float* c = sc + 4 * jj;
          mx_a = fmaxf(mx_a, fmaxf(c[0], c[1]));
          mx_b = fmaxf(mx_b, fmaxf(c[2], c[3]));
        }
        // every row has a valid key: finite
        const float ma = quad_max(mx_a) * sl, mb = quad_max(mx_b) * sl;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2 * kKeyTiles; ++jj) {
          float* c = sc + 4 * jj;
          c[0] = ex2(fmaf(c[0], sl, -ma));   // masked keys: 2^-inf = 0
          c[1] = ex2(fmaf(c[1], sl, -ma));
          c[2] = ex2(fmaf(c[2], sl, -mb));
          c[3] = ex2(fmaf(c[3], sl, -mb));
          sum_a += c[0] + c[1];
          sum_b += c[2] + c[3];
        }
        ra = 1.f / quad_sum(sum_a);
        rb = 1.f / quad_sum(sum_b);
      }
      uint32_t pa[kKeyTiles][4], pl[kFlat ? kKeyTiles : 1][4];
#pragma unroll
      for (int u = 0; u < kKeyTiles; ++u) {
        const float* c = sc + 8 * u;
        if constexpr (kFlat) {
          split_bf16(c[0] * ra, c[1] * ra, &pa[u][0], &pl[u][0]);
          split_bf16(c[2] * rb, c[3] * rb, &pa[u][1], &pl[u][1]);
          split_bf16(c[4] * ra, c[5] * ra, &pa[u][2], &pl[u][2]);
          split_bf16(c[6] * rb, c[7] * rb, &pa[u][3], &pl[u][3]);
        } else {
          pa[u][0] = pack_bf16(c[0] * ra, c[1] * ra);
          pa[u][1] = pack_bf16(c[2] * rb, c[3] * rb);
          pa[u][2] = pack_bf16(c[4] * ra, c[5] * ra);
          pa[u][3] = pack_bf16(c[6] * rb, c[7] * rb);
        }
      }

      // P.V: the accumulator's n8 tile nj (columns 8nj..8nj+7) in o[4nj..4nj+3]
      float o[D / 2];
      mbar_wait(&bars[L::kFullV + s], kv_parity);
      const uint64_t dv = rows_desc<RB>(vs);
      fence_regs<kKeyTiles * 4>(&pa[0][0]);
      if constexpr (kFlat) fence_regs<kKeyTiles * 4>(&pl[0][0]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kKeyTiles; ++u) {
        wgmma_rs_bf16<D, 1>(o, pa[u], dv + u * 16 * RB / 16, u > 0);
        if constexpr (kFlat) wgmma_rs_bf16<D, 1>(o, pl[u], dv + u * 16 * RB / 16, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<kKeyTiles * 4>(&pa[0][0]);
      if constexpr (kFlat) fence_regs<kKeyTiles * 4>(&pl[0][0]);

      // the output tile through shared memory (the last store has read it), out by TMA
      if (lead) tma_store_wait<true>();
      group_sync(g);
      const int r0 = wi * 16 + qd;
#pragma unroll
      for (int nj = 0; nj < DN; ++nj) {
        const int cb = (nj * 8 + 2 * t4) * 2;
        *reinterpret_cast<uint32_t*>(os + swizzle<RB>(r0 * RB + cb)) = pack_bf16(o[4 * nj], o[4 * nj + 1]);
        *reinterpret_cast<uint32_t*>(os + swizzle<RB>((r0 + 8) * RB + cb)) = pack_bf16(o[4 * nj + 2], o[4 * nj + 3]);
      }
      fence_async_smem();
      group_sync(g);
      if (lead) tma_store(to, os, t * kQRows, h, b);
    }
    // the stage is released once this group's products over it are done
    // (a group with no tile of the instance waits for it too, so that its
    // arrival counts toward this use of the stage)
    mbar_wait(&bars[L::kFullK + s], kv_parity);
    mbar_wait(&bars[L::kFullV + s], kv_parity);
    mbar_arrive(&bars[L::kEmptyKV + s]);
  }
  if (lead) tma_store_wait<false>();
}

template <int D, bool kFlat>
__global__ void __launch_bounds__(kThreads, 1) vit_attn_bf16(const __grid_constant__ CUtensorMap tq,
                                                             const __grid_constant__ CUtensorMap tk,
                                                             const __grid_constant__ CUtensorMap tv,
                                                             const __grid_constant__ CUtensorMap to, const Plan p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kBars; ++i)
      mbar_init(&bars[i], i >= L::kEmptyQ ? 128 : i >= L::kEmptyKV && i < L::kFullQ ? kGroups * 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // warp indices broadcast from lane 0, so that ptxas sees the branches
  // around the products as warp-uniform; the roles never reconverge
  // (ptxas keeps `setmaxnreg` only then)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (warp >= kGroups * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kGroups * 128) produce<D>(&tq, &tk, &tv, smem, bars, p);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<D, kFlat>(&to, smem, bars, p, warp / 4, warp % 4);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime: the library links nothing new
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;   // one per library (internal linkage)
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// the 4-D map (Dh, rows, heads, batch) of a bf16 operand with its element
// strides, boxes of `box_rows` rows of one head, in the swizzle of Dh's width
cudaError_t tensor_map(CUtensorMap* map, const void* p, Strides st, int nb, int nh, int rows, int d, int box_rows) {
  EncodeTiled encode;
  const cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)nh, (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)d, (cuuint32_t)box_rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = d == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- fp32

constexpr int kKeysPerLane = (kMaxS + 31) / 32;

size_t smem_f32(int s, int d, int warps) {
  return ((size_t)s * (d + 1) + (size_t)s * d + (size_t)warps * (kMaxD + kMaxS)) * 4;
}

// kFlat (K8): s query rows, the first s_keys of them keys; otherwise (K9)
// s_keys is not read and all s rows are keys
template <bool kFlat>
__global__ void __launch_bounds__(kMaxWarps * 32) vit_attn_f32(
    Operand q, Operand k, Operand v, float* __restrict__ out, Strides ost, int nh, int s, int d,
    float scale, int s_keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32, ks = d + 1;
  const int sk = kFlat ? s_keys : s;
  float* k_s = reinterpret_cast<float*>(smem);    // [sk][d + 1]
  float* v_s = k_s + (size_t)sk * ks;             // [sk][d]
  float* q_w = v_s + (size_t)sk * d;              // [warps][kMaxD]
  float* p_w = q_w + warps * kMaxD;               // [warps][kMaxS]

  const int inst = blockIdx.y, b = inst / nh, h = inst % nh;
  const float* qp = (const float*)q.p + b * q.st.b + h * q.st.h;
  const float* kp = (const float*)k.p + b * k.st.b + h * k.st.h;
  const float* vp = (const float*)v.p + b * v.st.b + h * v.st.h;
  float* op = out + b * ost.b + h * ost.h;

  for (int idx = threadIdx.x; idx < sk * d; idx += blockDim.x) {
    const int r = idx / d, c = idx % d;
    k_s[r * ks + c] = kp[r * k.st.s + c];
    v_s[r * d + c] = vp[r * v.st.s + c];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = q_w + warp * kMaxD;
  float* ps = p_w + warp * kMaxS;
  const int rows = 16 * warps, r_end = min(s, (blockIdx.x + 1) * rows);
  for (int r = blockIdx.x * rows + warp; r < r_end; r += warps) {
    for (int c = lane; c < d; c += 32) qs[c] = kFlat ? qp[r * q.st.s + c] : qp[r * q.st.s + c] * scale;
    __syncwarp();
    float sc[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      float dot = -INFINITY;
      if (j < sk) {
        dot = 0.f;
        const float* krow = k_s + j * ks;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[c], krow[c], dot);
        if (kFlat) dot *= scale;   // K8: the scale on the fp32 score
      }
      sc[i] = dot;
      mx = fmaxf(mx, dot);
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      sc[i] = expf(sc[i] - mx);
      sum += sc[i];
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < sk) ps[j] = sc[i] / sum;
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < sk; ++j) acc = fmaf(ps[j], v_s[j * d + c], acc);
      op[r * ost.s + c] = acc;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- launch

// Raise the kernel's dynamic shared-memory limit once to the most any call
// of it can ask for; a later call that needs more fails at launch.
template <auto Kern>
cudaError_t allow_smem(size_t most) {
  static bool done = false;   // one flag per kernel (internal linkage)
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  done = err == cudaSuccess;
  return err;
}

// S's 16-row tiles over blocks of at most max_warps warps, evenly: (blocks, warps)
inline void block_shape(int s, int max_warps, int* blocks, int* warps) {
  const int tiles = (s + 15) / 16;
  *blocks = (tiles + max_warps - 1) / max_warps;
  *warps = (tiles + *blocks - 1) / *blocks;
}

// s query rows; with kFlat the first s_keys of them are the keys. The plan:
// 64-row query tiles, all kMaxS keys (K and V each in two TMA boxes, zeros
// past the keys), one block per SM up to one per instance.
template <int D, bool kFlat>
cudaError_t launch_bf16(Operand q, Operand k, Operand v, void* out, Strides ost, int nb, int nh, int s, float scale,
                        int s_keys, cudaStream_t st) {
  Plan p;
  p.nh = nh;
  p.instances = nb * nh;
  p.s_q = s;
  p.keys = kFlat ? s_keys : s;
  p.q_tiles = (s + kQRows - 1) / kQRows;
  p.scale = scale;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = tensor_map(&tq, q.p, q.st, nb, nh, s, D, kQRows);
  if (err == cudaSuccess) err = tensor_map(&tk, k.p, k.st, nb, nh, p.keys, D, kBoxRows);
  if (err == cudaSuccess) err = tensor_map(&tv, v.p, v.st, nb, nh, p.keys, D, kBoxRows);
  if (err == cudaSuccess) err = tensor_map(&to, out, ost, nb, nh, s, D, kQRows);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem<vit_attn_bf16<D, kFlat>>(Layout<D>::bytes);
  if (err != cudaSuccess) return err;
  vit_attn_bf16<D, kFlat><<<p.instances < sms ? p.instances : sms, kThreads, Layout<D>::bytes, st>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <bool kFlat>
int launch(const void* q, const void* k, const void* v, void* out, int nb, int nh, int s, int s_keys, int d,
           long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss, long long vsb,
           long long vsh, long long vss, long long osb, long long osh, long long oss, float scale, int dtype,
           void* stream) {
  if (s < 1 || s > kMaxS || s_keys < 1 || s_keys > s || (d != 16 && d != 32 && d != 64) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (nb < 1 || nh < 1 || (long long)nb * nh > 65535) return (int)cudaErrorInvalidValue;
  const Operand qo{q, {qsb, qsh, qss}}, ko{k, {ksb, ksh, kss}}, vo{v, {vsb, vsh, vss}};
  const Strides ost{osb, osh, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (d) {
      case 16: return (int)launch_bf16<16, kFlat>(qo, ko, vo, out, ost, nb, nh, s, scale, s_keys, st);
      case 32: return (int)launch_bf16<32, kFlat>(qo, ko, vo, out, ost, nb, nh, s, scale, s_keys, st);
      default: return (int)launch_bf16<64, kFlat>(qo, ko, vo, out, ost, nb, nh, s, scale, s_keys, st);
    }
  }
  int blocks, warps;
  block_shape(s, kMaxWarps, &blocks, &warps);
  const dim3 grid(blocks, nb * nh);
  cudaError_t err = allow_smem<vit_attn_f32<kFlat>>(smem_f32(kMaxS, kMaxD, kMaxWarps));
  if (err != cudaSuccess) return (int)err;
  vit_attn_f32<kFlat><<<grid, warps * 32, smem_f32(kFlat ? s_keys : s, d, warps), st>>>(
      qo, ko, vo, (float*)out, ost, nh, s, d, scale, s_keys);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: element (b, h, r, c) at p[b * sb + h * sh + r * ss + c], Dh
// contiguous; strides in elements, multiples of 8 (bf16) and pointers
// 16-byte aligned. S in [1, 272]; Dh 16, 32 or 64. dtype 0 = fp32 (CUDA
// cores), 1 = bf16 (tensor cores).
extern "C" int vit_attention_fwd(const void* q, const void* k, const void* v, void* out, int nb,
                                 int nh, int s, int d, long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss, long long vsb,
                                 long long vsh, long long vss, long long osb, long long osh,
                                 long long oss, float scale, int dtype, void* stream) {
  return launch<false>(q, k, v, out, nb, nh, s, s, d, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                       scale, dtype, stream);
}

// K8: as vit_attention_fwd over s_pad query rows (the flat workspace's
// (B, S_pad, H*Dh) as (batch, head, row) strides), the first s_real of them
// the keys; the scale multiplies the fp32 scores.
extern "C" int flat_vit_attention_fwd(const void* q, const void* k, const void* v, void* out, int nb, int nh,
                                      int s_pad, int s_real, int d, long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                                      long long vss, long long osb, long long osh, long long oss, float scale,
                                      int dtype, void* stream) {
  return launch<true>(q, k, v, out, nb, nh, s_pad, s_real, d, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh,
                      oss, scale, dtype, stream);
}
