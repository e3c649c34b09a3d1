// Prefill attention forward kernels for Hopper (sm_90a).
//
//   K4 flash_attention_fwd  replaces open_flamingo_tpu/ops/flash_attention.py
//                           `_attention_kernel` via `_flash_forward`:
//                           causal (runtime q_offset), key pad mask, ALiBi
//                           slope * (j - (S - 1)) computed in the kernel.
//   K5 masked_xattn_fwd     replaces open_flamingo_tpu/ops/masked_xattn.py
//                           `_xattn_kernel` via `_xattn_forward`: text ->
//                           media-latent attention under the mask
//                           text_time[i] == j / n_latents + 1.
//
// Both share one streaming-softmax skeleton with two mask policies. A row
// with no valid key produces exact zeros (the TPU kernels' denominator
// guard), which the immediate-media rule of the gated cross-attention
// relies on. Given a non-null `lse`, each also writes the per-row
// logsumexp (BH, Tq) fp32 (`with_lse=True` in the TPU kernels), which the
// backward kernels K4b/K5b (attention_backward.cu) re-exponentiate against;
// rows with no valid key get 0. The mask policies live in
// attention_masks.cuh, shared with the backward.
//
// Semantics, the TPU kernels' fp32 math: scores q.k^T summed in fp32,
// `scale` and the ALiBi bias applied in fp32, the online max and sum in
// fp32, P.V in fp32 with fp32 P, one rounding of the output.
//
// bf16: tensor cores, FlashAttention-2's forward on `mma.sync` m16n8k16
// (the helpers of mma_frag.cuh, shared with K9/K8, and of
// attention_tiles.cuh, shared with K4b/K5b). Each warp owns 16 query
// rows; a block has 1-4 warps, fewer while the grid would not give every SM
// one block (causal: a block's warps share the staged key prefix) or two
// (media: each warp's images are its own), so that short prompts still
// fill the 132 SMs. q's rows are staged by `cp.async` and its A fragments
// loaded once into registers by `ldmatrix`. K and V tiles of 64 keys are
// staged by `cp.async` into a two-stage ring in dynamic shared memory, rows
// padded by 8 bf16 so that `ldmatrix` is conflict-free and Dh zero-padded
// to a multiple of 16 (any Dh <= 128); tile t + 1's copies are in flight
// while tile t computes.
// S = q.k^T lands in fp32 accumulators (B fragments by `ldmatrix.x4` on K);
// mask, scale and bias are applied per accumulator element from its (row,
// key) index, the row max and sum are quad shuffles, with no shared-memory
// round trip and no barrier between the phases. P enters P.V as a hi/lo
// pair of bf16 A fragments built straight from the accumulators (hi =
// bf16(P), lo = bf16(P - hi): exact products, fp32 sums, P within 2^-17),
// two `mma.sync` per fragment, as K8 does; V's B fragments come from
// `ldmatrix.x4.trans`. O accumulates in registers, rescaled by alpha each
// tile. Each row asks its mask policy once for the interval of keys it may
// see; a block loads only the key tiles its rows' intervals cover (K4: no
// causal tile wholly above the diagonal; K5: [(t_min - 1) n_latents,
// t_max n_latents) of the smallest nonzero and largest text_time of its
// rows, where the FMA body walked all S keys), and a warp skips the 16-key
// groups its rows cannot see.
//
// fp32: CUDA cores, no TF32 (which keeps ~3 digits). One block of 128
// threads per (bh, tile of 16 query rows) walks 32-key tiles staged in
// shared memory as fp32, scores, softmax and P.V as `fmaf` loops with a
// barrier between the phases; the running state lives in registers
// (accumulator) and shared memory (max, sum). The same body in bf16 is
// exported as `*_fwd_fma`, the yardstick the tensor-core body replaced:
// timed beside it on the card, never called by the port's wrappers.
//
// Bound. At the serving path's shapes (B*H = 128 or 64 rows of 32 queries,
// S = 64 keys, Dh = 128 or 64) and the train step's (MMC4: B*H 64 x 256
// queries, Dh 128; 32 x 256 over 384 media keys, Dh 64) the work is under
// 1.6 GFLOP (the hi/lo pass included) over up to 17 MB: the bytes bound
// the card (5 us at MMC4 T256 against 1.6 us of tensor-core time), so the
// design keeps the scores and P on chip and the copies in flight;
// `mma.sync` has rate to spare. wgmma and TMA would come after the table
// says the kernel still sits far from its bound.

#include <math.h>

#include "attention_masks.cuh"
#include "attention_tiles.cuh"
#include "mma_frag.cuh"

namespace {

// ---------------------------------------------------------------- fp32 (and the bf16 yardstick): FMA

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane in the softmax)
constexpr int kMaxD = 128;
constexpr int kAcc = kBQ * kMaxD / kThreads;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int tq, int s, int d, float scale, Mask mask) {
  __shared__ float q_s[kBQ][kMaxD + 1];
  __shared__ float k_s[kBK][kMaxD + 1];
  __shared__ float v_s[kBK][kMaxD];
  __shared__ float p_s[kBQ][kBK + 1];
  __shared__ float m_s[kBQ], l_s[kBQ], alpha_s[kBQ];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const T* qb = q + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * s * d;
  const T* vb = v + (size_t)bh * s * d;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    int i = idx / d, c = idx % d;
    q_s[i][c] = (q0 + i < tq) ? to_f32(qb[(size_t)(q0 + i) * d + c]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  const int kend = mask.key_end(min(q0 + kBQ, tq) - 1, s);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      int j = idx / d, c = idx % d;
      bool in = k0 + j < s;
      k_s[j][c] = in ? to_f32(kb[(size_t)(k0 + j) * d + c]) : 0.f;
      v_s[j][c] = in ? to_f32(vb[(size_t)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();

    // scores: a warp holds one query row, a lane one key
    for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
      int i = idx / kBK, j = idx % kBK;
      int qi = q0 + i, kj = k0 + j;
      float sc = -INFINITY;
      if (qi < tq && kj < s && mask.allowed(bh, qi, kj, s)) {
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(q_s[i][c], k_s[j][c], dot);
        sc = dot + mask.bias(bh, kj, s);
      }
      p_s[i][j] = sc;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int i = warp; i < kBQ; i += kWarps) {
      float sc = p_s[i][lane];
      float m_prev = m_s[i];
      float m_new = fmaxf(m_prev, warp_max(sc));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = expf(sc - m_new);          // masked keys: exp(-inf) = 0
        alpha = expf(m_prev - m_new);  // first valid tile: exp(-inf) = 0
      }
      float sum = warp_sum(p);
      p_s[i][lane] = p;
      if (lane == 0) {
        m_s[i] = m_new;
        l_s[i] = alpha * l_s[i] + sum;
        alpha_s[i] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; consecutive threads take consecutive columns
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      int idx = tid + r * kThreads;
      if (idx < kBQ * d) {
        int i = idx / d, c = idx % d;
        float a = acc[r] * alpha_s[i];
        for (int j = 0; j < kBK; ++j) a = fmaf(p_s[i][j], v_s[j][c], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    int idx = tid + r * kThreads;
    if (idx < kBQ * d) {
      int i = idx / d, c = idx % d;
      if (q0 + i < tq) {
        float l = l_s[i];
        store(&out[((size_t)bh * tq + q0 + i) * d + c], acc[r] / (l == 0.f ? 1.f : l));
      }
    }
  }
  // the logsumexp the backward re-exponentiates against: m + log l of the
  // same running max and sum; rows with no valid key get 0 (their P is
  // masked to 0 there)
  if (lse != nullptr && tid < kBQ && q0 + tid < tq) {
    float l = l_s[tid];
    lse[(size_t)bh * tq + q0 + tid] = l > 0.f ? m_s[tid] + logf(l) : 0.f;
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

constexpr int kTileKeys = 64;      // keys per staged K/V tile
constexpr int kStages = 2;         // tiles of the ring: one in flight while one computes (3 timed no faster)
constexpr int kMaxWarps = 4;       // warps per block, 16 query rows each

// one stage of the ring: a K and a V tile
template <int DP>
constexpr size_t stage_bytes() { return 2 * (size_t)kTileKeys * row_stride<DP>() * sizeof(__nv_bfloat16); }

// the q rows of a block's warps: 16 rows of KS each (at most a stage's 128)
template <int DP>
constexpr size_t q_bytes(int warps) { return (size_t)warps * 16 * row_stride<DP>() * sizeof(__nv_bfloat16); }
static_assert(kMaxWarps * 16 <= 2 * kTileKeys, "the q rows fit in a stage");

// The ring's stages for S keys: as many as a block's tiles can use, up to
// kStages (a block's key range never spans more than S keys). The q rows go
// where the last stage goes when there are kStages (it is first written
// after they are read), else after the ring.
__host__ __device__ inline int ring_stages(int s) { return max(1, min(kStages, (s + kTileKeys - 1) / kTileKeys)); }

// Block (y, bh): query rows [16 warps y', 16 warps (y' + 1)) of instance
// bh, y' = gridDim.y - 1 - y (the last query tiles, which see the most keys
// under the causal mask, first); warp w the 16 rows from 16 (warps y' + w).
// `vec`: Dh a multiple of 8 and q, K, V 16-byte aligned, so rows are staged
// by `cp.async` 16 bytes at a time; otherwise element by element.
template <int DP, typename Mask>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_fwd_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int tq,
    int s, int d, float scale, bool vec, Mask mask) {
  constexpr int DK = DP / 16;           // k-steps of q.k^T
  constexpr int DN = DP / 8;            // n-tiles of P.V
  constexpr int KS = row_stride<DP>();
  constexpr int KG = kTileKeys / 16;    // 16-key groups of a tile: n-tile pairs of q.k^T, k-steps of P.V
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2][kMaxWarps];

  const int bh = blockIdx.x, warps = blockDim.x / 32;
  // [stages][K, V][kTileKeys][KS], then the warps' q rows ([warps][16][KS]),
  // which overlap the last stage when there are kStages (ring_stages)
  const int stages = ring_stages(s);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* q_s = ring + (size_t)(stages == kStages ? kStages - 1 : stages) * 2 * kTileKeys * KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = ((gridDim.y - 1 - blockIdx.y) * warps + warp) * 16;
  const int ra = row0 + g, rb = row0 + g + 8;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * s * d;
  const __nv_bfloat16* vb = v + (size_t)bh * s * d;

  // the keys [lo, hi) each of the lane's rows may see (rows past Tq: none),
  // their union over the warp, and over the block the tiles to load
  int lo_a = s, hi_a = 0, lo_b = s, hi_b = 0;
  if (ra < tq) mask.row_keys(bh, ra, s, &lo_a, &hi_a);
  if (rb < tq) mask.row_keys(bh, rb, s, &lo_b, &hi_b);
  int lo_w = min(lo_a, lo_b), hi_w = max(hi_a, hi_b);
  warp_range(&lo_w, &hi_w);
  if (lane == 0) {
    range_s[0][warp] = lo_w;
    range_s[1][warp] = hi_w;
  }
  __syncthreads();
  int k_lo = s, k_hi = 0;
  for (int w = 0; w < warps; ++w) {
    k_lo = min(k_lo, range_s[0][w]);
    k_hi = max(k_hi, range_s[1][w]);
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTileKeys - 1) / kTileKeys : 0;

  // tile t (keys k_lo + 64 t ...) into stage t % stages, one `cp.async`
  // group (empty past the last tile): its rows up to the block's last key
  // rounded up to the 16-key group (no warp reads a later row), zeros past
  // S and past Dh
  auto stage = [&](int t) {
    const int k0 = k_lo + t * kTileKeys;
    const int rows = t < n_tiles ? min(kTileKeys, (k_hi - k0 + 15) & ~15) : 0;
    __nv_bfloat16* ks = ring + (size_t)(t % stages) * 2 * kTileKeys * KS;
    copy_rows<DP>(ks, kb, k0, rows, s, d, vec, threadIdx.x, blockDim.x);
    copy_rows<DP>(ks + kTileKeys * KS, vb, k0, rows, s, d, vec, threadIdx.x, blockDim.x);
    cp_async_commit();
  };
  // the tile's keys valid for every row (before S, the pad mask; nonzero =
  // valid), read a tile ahead and tested only where used, so that the
  // load's latency hides behind a tile's work
  auto key_ok = [&](int t, int* ok) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = k_lo + t * kTileKeys + 32 * h + lane;
      ok[h] = kj < s ? mask.key_valid(bh, kj, s) : 0;
    }
  };
  int ok_now[2] = {0, 0}, ok_next[2] = {0, 0};

  // q's A fragments, once: the warp's 16 rows staged by the warp (their own
  // `cp.async` group, ahead of the first tiles'), then `ldmatrix.x4` (lane l
  // gives row l % 16 at column 8 (l / 16): a0..a3 in one instruction) while
  // those tiles' copies land; a barrier before the last stage takes the q
  // rows' place
  uint32_t qa[DK][4];
  if (n_tiles > 0) {
    __nv_bfloat16* qw = q_s + warp * 16 * KS;
    copy_rows<DP>(qw, qb, row0, 16, tq, d, vec, lane, 32);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) stage(t);
    key_ok(0, ok_now);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const __nv_bfloat16* qaddr = qw + (lane % 16) * KS + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) ldsm_x4(qa[kk], qaddr + kk * 16);
    __syncthreads();
  }

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max of rows a (g) and b (g + 8); l: this lane's part of each row's sum
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float slope = mask.slope(bh);
  // the row of tile l / 8 that lane l addresses in `ldmatrix`
  const int lr = lane % 8, lt = lane / 8;

  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);
    if (t + 1 < n_tiles) key_ok(t + 1, ok_next);
    cp_async_wait<kStages - 1>();    // tile t's group: the q rows', then one per tile, each in order
    __syncthreads();
    const int k0 = k_lo + t * kTileKeys;
    if (k0 < hi_w && k0 + kTileKeys > lo_w) {   // some row of the warp sees a key of the tile
      const __nv_bfloat16* ks = ring + (size_t)(t % stages) * 2 * kTileKeys * KS;
      const __nv_bfloat16* vs = ks + kTileKeys * KS;
      // the valid keys as bits: key k0 + 32h + i is bit i of valid[h]
      const uint32_t valid[2] = {__ballot_sync(0xffffffffu, ok_now[0] != 0),
                                 __ballot_sync(0xffffffffu, ok_now[1] != 0)};

      // scores: sc[j] is the 16 x 8 tile of keys k0 + 8j .. k0 + 8j + 7; a
      // group of 16 keys that no row of the warp sees is not multiplied
      // (every key of it is masked below)
      float sc[2 * KG][4];
#pragma unroll
      for (int j = 0; j < 2 * KG; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      // tiles: keys 16gq..16gq+7 at columns 16kk and 16kk + 8, then keys 16gq+8..16gq+15
      const __nv_bfloat16* kaddr = ks + ((lt >> 1) * 8 + lr) * KS + (lt & 1) * 8;
#pragma unroll
      for (int gq = 0; gq < KG; ++gq) {
        const int kg = k0 + 16 * gq;
        if (kg < hi_w && kg + 16 > lo_w) {
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, kaddr + gq * 16 * KS + kk * 16);
            mma_bf16(sc[2 * gq], qa[kk], b[0], b[1]);
            mma_bf16(sc[2 * gq + 1], qa[kk], b[2], b[3]);
          }
        }
      }

      // scale and bias in fp32 after the product, -inf where masked; row max
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KG; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = 8 * j + 2 * t4 + e;           // the key's place in the tile
          const int kj = k0 + off;
          const bool ok = (valid[j / 4] >> (off - 32 * (j / 4))) & 1u;
          const float bias = slope * (float)(kj - (s - 1));     // K5: slope 0
          float* c = sc[j];
          c[e] = ok && kj >= lo_a && kj < hi_a ? c[e] * scale + bias : -INFINITY;
          c[2 + e] = ok && kj >= lo_b && kj < hi_b ? c[2 + e] * scale + bias : -INFINITY;
          mx_a = fmaxf(mx_a, c[e]);
          mx_b = fmaxf(mx_b, c[2 + e]);
        }
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);

      // online softmax: a row with no valid key yet keeps m = -inf, P = 0 by
      // selection (not exp(-inf - -inf)) and its state 0
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = mn_a == -INFINITY ? 1.f : expf(m_a - mn_a);   // first valid tile: exp(-inf) = 0
      const float al_b = mn_b == -INFINITY ? 1.f : expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * KG; ++j) {
        float* c = sc[j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          c[e] = mn_a == -INFINITY ? 0.f : expf(c[e] - mn_a);              // masked keys: exp(-inf) = 0
          c[2 + e] = mn_b == -INFINITY ? 0.f : expf(c[2 + e] - mn_b);
          ps_a += c[e];
          ps_b += c[2 + e];
        }
      }
      l_a = al_a * l_a + ps_a;
      l_b = al_b * l_b + ps_b;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }

      // O += P.V: the C tiles of keys 16gq..16gq+15 are the A operand of
      // k-step gq; V's tiles: keys 16gq..16gq+7 and 16gq+8..16gq+15 at
      // columns 8n, then at 8n + 8
      const __nv_bfloat16* vaddr = vs + ((lt & 1) * 8 + lr) * KS + (lt >> 1) * 8;
#pragma unroll
      for (int gq = 0; gq < KG; ++gq) {
        const int kg = k0 + 16 * gq;
        if (kg < hi_w && kg + 16 > lo_w) {
          // fragment i: C tile 2gq + i / 2, row a (i even) or b (i odd)
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* c = sc[2 * gq + (i >> 1)] + (i & 1) * 2;
            split_bf16(c[0], c[1], &hi[i], &lo[i]);
          }
#pragma unroll
          for (int n = 0; n < DN; n += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, vaddr + gq * 16 * KS + n * 8);
            mma_bf16(o[n], hi, b[0], b[1]);
            mma_bf16(o[n], lo, b[0], b[1]);
            mma_bf16(o[n + 1], hi, b[2], b[3]);
            mma_bf16(o[n + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before tile t + kStages is staged into it
    ok_now[0] = ok_next[0];
    ok_now[1] = ok_next[1];
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float den_a = l_a == 0.f ? 1.f : l_a, den_b = l_b == 0.f ? 1.f : l_b;
  __nv_bfloat16* ob = out + (size_t)bh * tq * d;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ra < tq) store_pair(ob, ra, c, d, o[n][0] / den_a, o[n][1] / den_a);
    if (rb < tq) store_pair(ob, rb, c, d, o[n][2] / den_b, o[n][3] / den_b);
  }
  if (lse != nullptr && t4 == 0) {
    if (ra < tq) lse[(size_t)bh * tq + ra] = l_a > 0.f ? m_a + logf(l_a) : 0.f;
    if (rb < tq) lse[(size_t)bh * tq + rb] = l_b > 0.f ? m_b + logf(l_b) : 0.f;
  }
}

// ---------------------------------------------------------------- launch

// Blocks per SM the grid aims at. Causal rows share the keys before them:
// the warps of a block read the same staged tiles, so fewer, larger blocks
// stage less (one per SM). A media row sees its own image's keys alone: one
// warp a block stages no tile for another, so more, smaller blocks (two).
template <typename Mask>
constexpr int kFill = 2;
template <>
constexpr int kFill<CausalPadAlibi> = 1;

template <int DP, typename Mask>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq, int s,
                       int d, float scale, cudaStream_t st, Mask mask) {
  cudaError_t err = allow_smem<attention_fwd_mma<DP, Mask>>(kStages * stage_bytes<DP>());
  if (err != cudaSuccess) return err;
  int blocks, warps;
  block_shape(tq, bh, kFill<Mask>, kMaxWarps, &blocks, &warps);
  const int stages = ring_stages(s);
  const size_t smem = stages * stage_bytes<DP>() + (stages == kStages ? 0 : q_bytes<DP>(warps));
  const bool vec = d % 8 == 0 && ((uintptr_t)q % 16) == 0 && ((uintptr_t)k % 16) == 0 && ((uintptr_t)v % 16) == 0;
  attention_fwd_mma<DP, Mask><<<dim3(bh, blocks), warps * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
      (float*)lse, tq, s, d, scale, vec, mask);
  return cudaGetLastError();
}

// bf16 takes the tensor-core body (Dh padded to 16, 32, 64, 80, 96 or 128)
// unless `fma`; fp32 always the FMA body
template <typename Mask>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq, int s, int d,
           float scale, int dtype, bool fma, void* stream, Mask mask) {
  if (d < 1 || d > kMaxD || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && !fma) {
    if (tq > 16 * 65535) return (int)cudaErrorInvalidValue;
    if (d <= 16) return (int)launch_mma<16>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
    if (d <= 32) return (int)launch_mma<32>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
    if (d <= 64) return (int)launch_mma<64>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
    if (d <= 80) return (int)launch_mma<80>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
    if (d <= 96) return (int)launch_mma<96>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
    return (int)launch_mma<128>(q, k, v, out, lse, bh, tq, s, d, scale, st, mask);
  }
  dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  if (dtype == 0) {
    attention_fwd_kernel<float, Mask><<<grid, kThreads, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, tq, s, d, scale,
        mask);
  } else {
    attention_fwd_kernel<__nv_bfloat16, Mask><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)out, (float*)lse, tq, s, d, scale, mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, Tq, D); k/v (BH, S, D); pad (BH, S) uint8; slopes (BH,) fp32;
// out (BH, Tq, D); lse (BH, Tq) fp32 or null. dtype 0 = fp32 (CUDA cores),
// 1 = bf16 (tensor cores). D <= 128.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, const void* slopes, void* out, void* lse,
                                   int bh, int tq, int s, int d, int q_offset, int causal,
                                   float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, false, stream, mask);
}

// q (BH, Tq, D); k/v (BH, T_img * n_latents, D); text_time (BH, Tq) int32;
// lse (BH, Tq) fp32 or null.
extern "C" int masked_xattn_fwd(const void* q, const void* k, const void* v,
                                const void* text_time, void* out, void* lse, int bh, int tq,
                                int s, int d, int n_latents, float scale, int dtype,
                                void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, false, stream, mask);
}

// The FMA body in either dtype, with the arguments above: the CUDA-core
// kernel the bf16 tensor-core body replaced, kept as its yardstick.
extern "C" int flash_attention_fwd_fma(const void* q, const void* k, const void* v,
                                       const void* pad, const void* slopes, void* out, void* lse,
                                       int bh, int tq, int s, int d, int q_offset, int causal,
                                       float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, true, stream, mask);
}

extern "C" int masked_xattn_fwd_fma(const void* q, const void* k, const void* v,
                                    const void* text_time, void* out, void* lse, int bh, int tq,
                                    int s, int d, int n_latents, float scale, int dtype,
                                    void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, true, stream, mask);
}
