// Prefill attention backward kernels for Hopper (sm_90a): the training
// path's gradients of K4 and K5.
//
//   K4b flash_attention_bwd_dq / _dkv  replace open_flamingo_tpu/ops/
//        flash_attention.py `_flash_dq_kernel` and `_flash_dkv_kernel`
//        (run from `_flash_backward`): causal with a runtime q_offset, key
//        pad mask, ALiBi slope * (j - (S - 1)) recomputed from the index.
//   K5b masked_xattn_bwd_dq / _dkv     replace open_flamingo_tpu/ops/
//        masked_xattn.py `_xattn_dq_kernel` and `_xattn_dkv_kernel`: the
//        same under the media-time mask text_time[i] == j / n_latents + 1.
//
// FlashAttention-2's split, as the TPU kernels: from the forward's
// logsumexp, P = exp(s - lse) under the mask, dS = P * (dO V^T - delta);
// dq = scale * dS K walks the keys of one (bh, group of query rows), and
// dk = dS^T (scale * q), dv = P^T dO walk the queries of one (bh, group of
// keys). Both recompute s; neither materialises it in device memory.
// delta = rowsum(dO * O) is fused into the dq kernel, which writes it for
// the dkv kernel launched after it on the same stream (the JAX package
// computes it outside its Pallas calls). Two launches, no atomics: each
// output element is summed by one lane, so results are deterministic.
// Semantics, the TPU kernels' fp32 math: the five products summed in fp32
// with bf16 (or fp32) inputs, scale and bias applied in fp32, one rounding
// of each output.
//
// Exact zeros: a masked (q, k) pair has dS = P = 0 by selection, never
// exp(s - lse) of it, so masked keys get dk = dv = 0 and rows with no valid
// key get dq = 0 exactly, whatever lse holds there (0). A block with no
// tile to walk still stores its zeros (the outputs come from torch.empty).
// Every read is bounded (ragged Tq and S; the TPU kernels bound S only in
// the forward).
//
// Bound. At the train step's shapes (OF-3B; MPT self-attention LAION BH
// 128 x T 32, MMC4 BH 64 x T 256, Dh 128; gated xattn LAION BH 64 x Tq 32
// over S 64, MMC4 BH 32 x Tq 256 over S 384, Dh 64) a call reads q, k, v,
// O, dO and lse and writes dq, dk, dv: 2-34 MB, 1-10 us at 3.35 TB/s; its
// 10 Dh FLOPs per allowed pair (five products) are under 3 us of tensor
// cores. The bytes bound the card, so the design keeps s, P and dS on chip
// and the copies in flight, and walks only the pairs the mask allows.
//
// bf16: tensor cores, `mma.sync` m16n8k16 (the helpers of mma_frag.cuh and
// attention_tiles.cuh, shared with the forward). Each warp owns 16 rows: in
// dq 16 query rows, in dkv 16 keys; a block has 1-4 warps, sized as the
// forward's blocks so that short sequences still fill the 132 SMs. The
// warp's own rows (q and dO, or K and V) are staged once; tiles of 64 of the
// other side's rows (K and V, or q and dO) go through a two-stage
// `cp.async` ring in dynamic shared memory, rows padded by 8 bf16 so that
// `ldmatrix` is conflict-free and Dh zero-padded to 16, 32, 64, 80, 96 or
// 128; tile t + 1's copies are in flight while tile t computes.
// - dq: q's and dO's A fragments are loaded once by `ldmatrix`; per 16-key
//   group S = q.K^T and dP = dO.V^T land in fp32 accumulators (B by
//   `ldmatrix` on K and V); mask, scale and bias apply per accumulator
//   element, pad bits as ballot words read a tile ahead, as the forward
//   does; P and dS follow in registers, and dq += dS.K takes dS as a hi/lo
//   pair of bf16 A fragments (hi = bf16(dS), lo = bf16(dS - hi): exact
//   products, fp32 sums) with K's B fragments by `ldmatrix.trans`. Each row
//   asks its mask policy for its key interval (`row_keys`): a block loads
//   only the key tiles its rows can see (K5b: the images of its rows, not
//   all S keys), a warp skips the 16-key groups its rows cannot see. delta
//   comes from the staged dO rows and O.
// - dkv: S^T = K.q^T and dP^T = V.dO^T put keys on the accumulator rows, so
//   that P^T and dS^T are, as they stand, the A operands of dV += P^T.dO and
//   dK += dS^T.q (hi/lo pairs; dO's and q's B fragments by
//   `ldmatrix.trans`): nothing round-trips through shared memory. K's and
//   V's A fragments stay in registers at Dh <= 64; at Dh 128 the dK and dV
//   accumulators alone take 128 registers a lane, so they are read from
//   shared memory at each k-step. Each staged query brings its lse, delta
//   and key interval, read a tile ahead. A block walks only the queries
//   that may see one of its keys (`key_queries`: causal, from the first
//   that sees its first key; media, one scan of text_time for the first and
//   last query of its images), a warp only the 16-query groups where one of
//   them sees one of its keys.
//
// fp32: CUDA cores, no TF32 (which keeps ~3 digits): the FMA body, blocks of
// 128 threads over tiles staged in shared memory as fp32. dq: 16 query rows
// a block, 32-key tiles, V then K of a tile in one buffer; dkv: 16 keys a
// block, 16-query tiles; the causal mask's skipping only. The same body in
// bf16 is exported as `*_fma`, the yardstick the tensor-core body replaced:
// timed beside it on the card, never called by the port's wrappers.

#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "attention_masks.cuh"
#include "attention_tiles.cuh"
#include "mma_frag.cuh"

namespace {

// ---------------------------------------------------------------- fp32 (and the bf16 yardstick): FMA

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
// dq kernel
constexpr int kBQ = 16;     // query rows per block
constexpr int kBK = 32;     // keys per tile
constexpr int kAccQ = kBQ * kMaxD / kThreads;
// dkv kernel
constexpr int kBKV = 16;    // keys per block
constexpr int kBQV = 16;    // query rows per tile
constexpr int kAccKV = kBKV * kMaxD / kThreads;

template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int tq, int s, int d, float scale, Mask mask) {
  __shared__ float q_s[kBQ][kMaxD + 1];    // scale * q
  __shared__ float do_s[kBQ][kMaxD + 1];
  __shared__ float kv_s[kBK][kMaxD + 1];   // the tile's V, then its K
  __shared__ float ds_s[kBQ][kBK + 1];     // dO V^T, then dS
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)bh * tq;
  const T* kb = k + (size_t)bh * s * d;
  const T* vb = v + (size_t)bh * s * d;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    int i = idx / d, c = idx % d;
    bool in = q0 + i < tq;
    size_t off = (row0 + q0 + i) * d + c;
    q_s[i][c] = in ? to_f32(q[off]) * scale : 0.f;
    do_s[i][c] = in ? to_f32(dout[off]) : 0.f;
  }
  __syncthreads();
  // delta = rowsum(dO * O), one warp per row
  for (int i = warp; i < kBQ; i += kWarps) {
    float sum = 0.f;
    if (q0 + i < tq) {
      const T* orow = out + (row0 + q0 + i) * d;
      for (int c = lane; c < d; c += 32) sum = fmaf(do_s[i][c], to_f32(orow[c]), sum);
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      delta_s[i] = sum;
      lse_s[i] = q0 + i < tq ? lse[row0 + q0 + i] : 0.f;
      if (q0 + i < tq) delta[row0 + q0 + i] = sum;
    }
  }

  float acc[kAccQ];
#pragma unroll
  for (int r = 0; r < kAccQ; ++r) acc[r] = 0.f;

  const int kend = mask.key_end(min(q0 + kBQ, tq) - 1, s);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and delta_s is set)
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      int j = idx / d, c = idx % d;
      kv_s[j][c] = k0 + j < s ? to_f32(vb[(size_t)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();
    // dO V^T: a warp holds one query row, a lane one key
    for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
      int i = idx / kBK, j = idx % kBK;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(do_s[i][c], kv_s[j][c], dot);
      ds_s[i][j] = dot;
    }
    __syncthreads();
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      int j = idx / d, c = idx % d;
      kv_s[j][c] = k0 + j < s ? to_f32(kb[(size_t)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();
    // s, P and dS; each thread rewrites only its own (i, j) entries
    for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
      int i = idx / kBK, j = idx % kBK;
      int qi = q0 + i, kj = k0 + j;
      float ds = 0.f;
      if (qi < tq && kj < s && mask.allowed(bh, qi, kj, s)) {
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(q_s[i][c], kv_s[j][c], dot);
        float p = expf(dot + mask.bias(bh, kj, s) - lse_s[i]);
        ds = p * (ds_s[i][j] - delta_s[i]);
      }
      ds_s[i][j] = ds;
    }
    __syncthreads();
    // acc += dS K; consecutive threads take consecutive columns
#pragma unroll
    for (int r = 0; r < kAccQ; ++r) {
      int idx = tid + r * kThreads;
      if (idx < kBQ * d) {
        int i = idx / d, c = idx % d;
        float a = acc[r];
        for (int j = 0; j < kBK; ++j) a = fmaf(ds_s[i][j], kv_s[j][c], a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kAccQ; ++r) {
    int idx = tid + r * kThreads;
    if (idx < kBQ * d) {
      int i = idx / d, c = idx % d;
      if (q0 + i < tq) store(&dq[(row0 + q0 + i) * d + c], acc[r] * scale);
    }
  }
}

template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int tq, int s, int d, float scale, Mask mask) {
  __shared__ float k_s[kBKV][kMaxD + 1];
  __shared__ float v_s[kBKV][kMaxD + 1];
  __shared__ float q_s[kBQV][kMaxD + 1];   // scale * q
  __shared__ float do_s[kBQV][kMaxD + 1];
  __shared__ float p_s[kBQV][kBKV + 1];
  __shared__ float ds_s[kBQV][kBKV + 1];
  __shared__ float lse_s[kBQV], delta_s[kBQV];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBKV;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)bh * tq;
  const size_t key0 = (size_t)bh * s;

  for (int idx = tid; idx < kBKV * d; idx += kThreads) {
    int j = idx / d, c = idx % d;
    bool in = k0 + j < s;
    size_t off = (key0 + k0 + j) * d + c;
    k_s[j][c] = in ? to_f32(k[off]) : 0.f;
    v_s[j][c] = in ? to_f32(v[off]) : 0.f;
  }
  float dk_acc[kAccKV], dv_acc[kAccKV];
#pragma unroll
  for (int r = 0; r < kAccKV; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  const int qbegin = mask.query_begin(k0) / kBQV * kBQV;
  for (int q0 = qbegin; q0 < tq; q0 += kBQV) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBQV * d; idx += kThreads) {
      int i = idx / d, c = idx % d;
      bool in = q0 + i < tq;
      size_t off = (row0 + q0 + i) * d + c;
      q_s[i][c] = in ? to_f32(q[off]) * scale : 0.f;
      do_s[i][c] = in ? to_f32(dout[off]) : 0.f;
    }
    if (tid < kBQV) {
      bool in = q0 + tid < tq;
      lse_s[tid] = in ? lse[row0 + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < kBQV * kBKV; idx += kThreads) {
      int i = idx / kBKV, j = idx % kBKV;
      int qi = q0 + i, kj = k0 + j;
      float p = 0.f, ds = 0.f;
      if (qi < tq && kj < s && mask.allowed(bh, qi, kj, s)) {
        float sc = 0.f, dp = 0.f;
        for (int c = 0; c < d; ++c) {
          sc = fmaf(q_s[i][c], k_s[j][c], sc);
          dp = fmaf(do_s[i][c], v_s[j][c], dp);
        }
        p = expf(sc + mask.bias(bh, kj, s) - lse_s[i]);
        ds = p * (dp - delta_s[i]);
      }
      p_s[i][j] = p;
      ds_s[i][j] = ds;
    }
    __syncthreads();
    // dv += P^T dO, dk += dS^T (scale q); consecutive threads take
    // consecutive columns
#pragma unroll
    for (int r = 0; r < kAccKV; ++r) {
      int idx = tid + r * kThreads;
      if (idx < kBKV * d) {
        int j = idx / d, c = idx % d;
        float a = dv_acc[r], b = dk_acc[r];
        for (int i = 0; i < kBQV; ++i) {
          a = fmaf(p_s[i][j], do_s[i][c], a);
          b = fmaf(ds_s[i][j], q_s[i][c], b);
        }
        dv_acc[r] = a;
        dk_acc[r] = b;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kAccKV; ++r) {
    int idx = tid + r * kThreads;
    if (idx < kBKV * d) {
      int j = idx / d, c = idx % d;
      if (k0 + j < s) {
        size_t off = (key0 + k0 + j) * d + c;
        store(&dk[off], dk_acc[r]);
        store(&dv[off], dv_acc[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

constexpr int kTile = 64;          // rows per staged tile: keys (dq) or queries (dkv)
constexpr int kStages = 2;         // tiles of the ring: one in flight while one computes
constexpr int kMaxWarps = 4;       // warps per block: 16 query rows (dq) or 16 keys (dkv) each

// one stage of the ring: a K and a V tile (dq), a q and a dO tile (dkv)
template <int DP>
constexpr size_t stage_bytes() { return 2 * (size_t)kTile * row_stride<DP>() * sizeof(__nv_bfloat16); }

// a block's own rows: each warp's 16 q and 16 dO rows (dq), 16 K and 16 V rows (dkv)
template <int DP>
constexpr size_t own_bytes(int warps) { return (size_t)warps * 32 * row_stride<DP>() * sizeof(__nv_bfloat16); }
static_assert(kMaxWarps * 32 <= 2 * kTile, "a block's own rows fit in a stage");

// the ring's stages for a walk over at most `rows` rows: as many as its tiles can use, up to kStages
__host__ __device__ inline int ring_stages(int rows) { return max(1, min(kStages, (rows + kTile - 1) / kTile)); }

// A fragment of k-step kk of the 16 rows staged at w (rows of KS): lane l
// addresses row l % 16 at column 8 (l / 16), a0..a3 in one `ldmatrix.x4`
template <int KS>
__device__ __forceinline__ void a_frag(uint32_t* a, const __nv_bfloat16* w, int kk, int lane) {
  ldsm_x4(a, w + (lane % 16) * KS + (lane / 16) * 8 + kk * 16);
}

// the two C tiles of a 16 x 16 operand (columns 0..7, then 8..15) as the
// hi/lo bf16 pair of its A fragment: fragment i is C tile i / 2, row g (i
// even) or g + 8 (i odd)
__device__ __forceinline__ void c_to_a(const float (*c)[4], uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* x = c[i >> 1] + (i & 1) * 2;
    split_bf16(x[0], x[1], &hi[i], &lo[i]);
  }
}

// acc += (hi + lo) B over DN n-tiles: B the 16 staged rows from p (the k of
// the product; lane addresses of `ldmatrix.x4.trans`, columns 8n), two
// `mma.sync` per fragment, fp32 sums
template <int DN>
__device__ __forceinline__ void mma_trans(float (*acc)[4], const uint32_t* hi, const uint32_t* lo,
                                          const __nv_bfloat16* p) {
#pragma unroll
  for (int n = 0; n < DN; n += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + n * 8);
    mma_bf16(acc[n], hi, b[0], b[1]);
    mma_bf16(acc[n], lo, b[0], b[1]);
    mma_bf16(acc[n + 1], hi, b[2], b[3]);
    mma_bf16(acc[n + 1], lo, b[2], b[3]);
  }
}

// the fp32 dot product of 8 bf16 pairs, added to acc
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// dq. Block (y, bh): query rows [16 warps y', 16 warps (y' + 1)) of
// instance bh, y' = gridDim.y - 1 - y (the last, which see the most keys
// under the causal mask, first); warp w the 16 rows from 16 (warps y' + w).
// Writes delta = rowsum(dO * O) of its rows for the dkv launch. `vec`: Dh a
// multiple of 8 and every operand 16-byte aligned, so rows are staged by
// `cp.async` and O read 16 bytes at a time; otherwise element by element.
template <int DP, typename Mask>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_bwd_dq_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int tq, int s, int d, float scale, bool vec, Mask mask) {
  constexpr int DK = DP / 16;           // k-steps of q.K^T and dO.V^T
  constexpr int DN = DP / 8;            // n-tiles of dS.K
  constexpr int KS = row_stride<DP>();
  constexpr int KG = kTile / 16;        // 16-key groups of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2][kMaxWarps];

  const int bh = blockIdx.x, warps = blockDim.x / 32;
  // [stages][K, V][kTile][KS], then the warps' q and dO rows ([warps][q,
  // dO][16][KS]), which overlap the last stage when there are kStages (it is
  // first written after they are read)
  const int stages = ring_stages(s);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* own = ring + (size_t)(stages == kStages ? kStages - 1 : stages) * 2 * kTile * KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = ((gridDim.y - 1 - blockIdx.y) * warps + warp) * 16;
  const int ra = row0 + g, rb = row0 + g + 8;
  const size_t base = (size_t)bh * tq;          // the instance's first query row
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
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;

  // tile t (keys k_lo + 64 t ...) into stage t % stages, one `cp.async`
  // group (empty past the last tile): its rows up to the block's last key
  // rounded up to the 16-key group, zeros past S and past Dh
  auto stage = [&](int t) {
    const int k0 = k_lo + t * kTile;
    const int rows = t < n_tiles ? min(kTile, (k_hi - k0 + 15) & ~15) : 0;
    __nv_bfloat16* ks = ring + (size_t)(t % stages) * 2 * kTile * KS;
    copy_rows<DP>(ks, kb, k0, rows, s, d, vec, threadIdx.x, blockDim.x);
    copy_rows<DP>(ks + kTile * KS, vb, k0, rows, s, d, vec, threadIdx.x, blockDim.x);
    cp_async_commit();
  };
  // the tile's keys valid for every row (the pad mask; nonzero = valid),
  // read a tile ahead and tested only where used
  auto key_ok = [&](int t, int* ok) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = k_lo + t * kTile + 32 * h + lane;
      ok[h] = kj < s ? mask.key_valid(bh, kj, s) : 0;
    }
  };
  int ok_now[2] = {0, 0}, ok_next[2] = {0, 0};

  // the warp's q and dO rows, their own `cp.async` group ahead of the first
  // tiles'; their A fragments by `ldmatrix` while those tiles' copies land;
  // delta from the staged dO rows and O; a barrier before the last stage
  // takes the rows' place
  __nv_bfloat16* qw = own + warp * 32 * KS;
  __nv_bfloat16* dw = qw + 16 * KS;
  copy_rows<DP>(qw, q + base * d, row0, 16, tq, d, vec, lane, 32);
  copy_rows<DP>(dw, dout + base * d, row0, 16, tq, d, vec, lane, 32);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage(t);
  key_ok(0, ok_now);
  cp_async_wait<kStages - 1>();
  __syncwarp();
  uint32_t qa[DK][4], da[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    a_frag<KS>(qa[kk], qw, kk, lane);
    a_frag<KS>(da[kk], dw, kk, lane);
  }
  // lane l sums half l % 2 of row l / 2 (its 16-byte chunks in turn); the
  // pair's sum is the row's delta
  float part = 0.f;
  const int rd = row0 + lane / 2;
  if (rd < tq) {
    const __nv_bfloat16* orow = out + (base + rd) * d;
    const __nv_bfloat16* drow = dw + (lane / 2) * KS;
    if (vec) {
      for (int c = (lane & 1) * 8; c < d; c += 16)
        part = dot8(*reinterpret_cast<const uint4*>(orow + c), *reinterpret_cast<const uint4*>(drow + c), part);
    } else {
      for (int c = lane & 1; c < d; c += 2) part = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if ((lane & 1) == 0 && rd < tq) delta[base + rd] = part;
  const float dl_a = __shfl_sync(0xffffffffu, part, 2 * g), dl_b = __shfl_sync(0xffffffffu, part, 2 * g + 16);
  const float lse_a = ra < tq ? lse[base + ra] : 0.f, lse_b = rb < tq ? lse[base + rb] : 0.f;
  __syncthreads();

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float slope = mask.slope(bh);
  // the row of tile l / 8 that lane l addresses in `ldmatrix`
  const int lr = lane % 8, lt = lane / 8;

  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);
    if (t + 1 < n_tiles) key_ok(t + 1, ok_next);
    cp_async_wait<kStages - 1>();    // tile t's group: the rows', then one per tile, each in order
    __syncthreads();
    const int k0 = k_lo + t * kTile;
    if (k0 < hi_w && k0 + kTile > lo_w) {   // some row of the warp sees a key of the tile
      const __nv_bfloat16* ks = ring + (size_t)(t % stages) * 2 * kTile * KS;
      // the valid keys as bits: key k0 + 32h + i is bit i of valid[h]
      const uint32_t valid[2] = {__ballot_sync(0xffffffffu, ok_now[0] != 0),
                                 __ballot_sync(0xffffffffu, ok_now[1] != 0)};
      // B of q.K^T and dO.V^T: keys 16gq..16gq+7 at columns 16kk and 16kk +
      // 8, then keys 16gq+8..16gq+15 (V's rows kTile rows after K's)
      const __nv_bfloat16* kaddr = ks + ((lt >> 1) * 8 + lr) * KS + (lt & 1) * 8;
      // B of dS.K (`.trans`): keys 16gq..16gq+7 and 16gq+8..16gq+15 at
      // columns 8n, then at 8n + 8
      const __nv_bfloat16* taddr = ks + ((lt & 1) * 8 + lr) * KS + (lt >> 1) * 8;
#pragma unroll
      for (int gq = 0; gq < KG; ++gq) {
        const int kg = k0 + 16 * gq;
        if (kg < hi_w && kg + 16 > lo_w) {    // a group no row of the warp sees is not multiplied
          // sc[j], dp[j]: the 16 x 8 tiles of keys kg + 8j .. kg + 8j + 7
          float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, kaddr + gq * 16 * KS + kk * 16);
            mma_bf16(sc[0], qa[kk], b[0], b[1]);
            mma_bf16(sc[1], qa[kk], b[2], b[3]);
            ldsm_x4(b, kaddr + (kTile + gq * 16) * KS + kk * 16);
            mma_bf16(dp[0], da[kk], b[0], b[1]);
            mma_bf16(dp[1], da[kk], b[2], b[3]);
          }
          // P = exp(scale s + bias - lse) where the mask allows the pair, 0
          // by selection elsewhere; dS = P (dP - delta), in place of s
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int off = 16 * gq + 8 * j + 2 * t4 + e;     // the key's place in the tile
              const int kj = k0 + off;
              const bool ok = (valid[gq >> 1] >> (off & 31)) & 1u;
              const float bias = slope * (float)(kj - (s - 1));     // K5b: slope 0
              const float pa = ok && kj >= lo_a && kj < hi_a ? expf(sc[j][e] * scale + bias - lse_a) : 0.f;
              const float pb = ok && kj >= lo_b && kj < hi_b ? expf(sc[j][2 + e] * scale + bias - lse_b) : 0.f;
              sc[j][e] = pa * (dp[j][e] - dl_a);
              sc[j][2 + e] = pb * (dp[j][2 + e] - dl_b);
            }
          }
          // dq += dS.K: the group's dS is the A operand of one k-step
          uint32_t hi[4], lo[4];
          c_to_a(sc, hi, lo);
          mma_trans<DN>(acc, hi, lo, taddr + gq * 16 * KS);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before tile t + kStages is staged into it
    ok_now[0] = ok_next[0];
    ok_now[1] = ok_next[1];
  }

  // dq = scale dS K; rows that see no key store their zeros
  __nv_bfloat16* qb = dq + base * d;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ra < tq) store_pair(qb, ra, c, d, acc[n][0] * scale, acc[n][1] * scale);
    if (rb < tq) store_pair(qb, rb, c, d, acc[n][2] * scale, acc[n][3] * scale);
  }
}

// dk and dv. Block (y, bh): keys [16 warps y, 16 warps (y + 1)) of instance
// bh (the first keys, which the most queries see under the causal mask,
// first); warp w the 16 keys from 16 (warps y + w). It walks the query
// tiles of `key_queries`' interval for its keys. `vec` as in dq (q, K, V, dO).
template <int DP, typename Mask>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_bwd_dkv_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq,
    int s, int d, float scale, bool vec, Mask mask) {
  constexpr int DK = DP / 16;           // k-steps of K.q^T and V.dO^T
  constexpr int DN = DP / 8;            // n-tiles of P^T.dO and dS^T.q
  constexpr int KS = row_stride<DP>();
  constexpr int QG = kTile / 16;        // 16-query groups of a tile
  // K's and V's A fragments held in registers up to Dh 64; above, read by
  // `ldmatrix` at each k-step (dK and dV take 128 registers a lane at Dh 128)
  constexpr bool kHold = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  // each staged query's lse, delta and key interval [lo, hi), by stage
  __shared__ float lse_s[kStages][kTile], delta_s[kStages][kTile];
  __shared__ int lo_s[kStages][kTile], hi_s[kStages][kTile];

  const int bh = blockIdx.x, warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int kb0 = blockIdx.y * warps * 16, kb1 = min(s, kb0 + warps * 16);   // the block's keys
  const int kw0 = kb0 + warp * 16, kw1 = min(s, kw0 + 16);                   // the warp's
  const int ka = kw0 + g, kb = kw0 + g + 8;                                  // the lane's rows a and b
  const size_t base = (size_t)bh * tq;
  const __nv_bfloat16* qb = q + base * d;
  const __nv_bfloat16* db = dout + base * d;

  // the queries that may see a key of the block, in tiles of 64
  int q_lo, q_hi;
  mask.key_queries(bh, kb0, kb1, tq, s, &q_lo, &q_hi);
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + kTile - 1) / kTile : 0;

  // [stages][q, dO][kTile][KS], then the warps' K and V rows ([warps][K, V][16][KS])
  const int stages = ring_stages(tq);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kw = ring + (size_t)stages * 2 * kTile * KS + warp * 32 * KS;
  __nv_bfloat16* vw = kw + 16 * KS;

  // tile t (queries q_lo + 64 t ...) into stage t % stages, one `cp.async`
  // group (empty past the last tile): its rows up to the block's last query
  // rounded up to the 16-query group, zeros past Tq and past Dh
  auto stage = [&](int t) {
    const int q0 = q_lo + t * kTile;
    const int rows = t < n_tiles ? min(kTile, (q_hi - q0 + 15) & ~15) : 0;
    __nv_bfloat16* qs = ring + (size_t)(t % stages) * 2 * kTile * KS;
    copy_rows<DP>(qs, qb, q0, rows, tq, d, vec, threadIdx.x, blockDim.x);
    copy_rows<DP>(qs + kTile * KS, db, q0, rows, tq, d, vec, threadIdx.x, blockDim.x);
    cp_async_commit();
  };
  // tile t's lse, delta and key intervals (queries past Tq: none), query
  // q_lo + 64 t + c by thread c mod blockDim.x: loaded a tile ahead into
  // registers, stored into the tile's stage behind the compute of the tile
  // before it, so that the loads' latency hides behind a tile's work
  float m_lse[2], m_delta[2];
  int m_lo[2], m_hi[2];
  auto meta_load = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * blockDim.x, qi = q_lo + t * kTile + c;
      m_lse[i] = m_delta[i] = 0.f;
      m_lo[i] = s;
      m_hi[i] = 0;
      if (c < kTile && qi < tq) {
        m_lse[i] = lse[base + qi];
        m_delta[i] = delta[base + qi];
        mask.row_keys(bh, qi, s, &m_lo[i], &m_hi[i]);
      }
    }
  };
  auto meta_store = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < kTile) {
        lse_s[t % stages][c] = m_lse[i];
        delta_s[t % stages][c] = m_delta[i];
        lo_s[t % stages][c] = m_lo[i];
        hi_s[t % stages][c] = m_hi[i];
      }
    }
  };

  // the warp's K and V rows, their own `cp.async` group ahead of the first
  // tiles'; tile 0's metadata before the loop's first barrier
  copy_rows<DP>(kw, k + (size_t)bh * s * d, kw0, 16, s, d, vec, lane, 32);
  copy_rows<DP>(vw, v + (size_t)bh * s * d, kw0, 16, s, d, vec, lane, 32);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage(t);
  if (n_tiles > 0) {
    meta_load(0);
    meta_store(0);
  }
  if (n_tiles > 1) meta_load(1);
  uint32_t kh[kHold ? DK : 1][4], vh[kHold ? DK : 1][4];
  if constexpr (kHold) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      a_frag<KS>(kh[kk], kw, kk, lane);
      a_frag<KS>(vh[kk], vw, kk, lane);
    }
  }
  // the lane's keys: valid for every query (the pad mask), and their bias
  const bool ok_a = ka < s && mask.key_valid(bh, ka, s) != 0;
  const bool ok_b = kb < s && mask.key_valid(bh, kb, s) != 0;
  const float slope = mask.slope(bh);
  const float bias_a = slope * (float)(ka - (s - 1)), bias_b = slope * (float)(kb - (s - 1));

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const int lr = lane % 8, lt = lane / 8;

  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);
    cp_async_wait<kStages - 1>();    // tile t's group: the K/V rows', then one per tile, each in order
    __syncthreads();
    const int sl = t % stages;
    const __nv_bfloat16* qs = ring + (size_t)sl * 2 * kTile * KS;
    // B of K.q^T and V.dO^T: queries 16gq..16gq+7 at columns 16kk and 16kk
    // + 8, then queries 16gq+8..16gq+15 (dO's rows kTile rows after q's)
    const __nv_bfloat16* baddr = qs + ((lt >> 1) * 8 + lr) * KS + (lt & 1) * 8;
    // B of P^T.dO and dS^T.q (`.trans`): queries 16gq.. at columns 8n, then 8n + 8
    const __nv_bfloat16* taddr = qs + ((lt & 1) * 8 + lr) * KS + (lt >> 1) * 8;
#pragma unroll
    for (int gq = 0; gq < QG; ++gq) {
      // does a query of the group see a key of the warp? lane l asks for query 16 gq + l % 16
      const int cq = 16 * gq + (lane & 15);
      if (!__any_sync(0xffffffffu, lo_s[sl][cq] < kw1 && hi_s[sl][cq] > kw0)) continue;
      // st[j], dpt[j]: the 16 x 8 tiles of queries 16gq + 8j .. 16gq + 8j + 7, keys on the rows
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t a[4], b[4];
        const uint32_t* af = a;
        if constexpr (kHold) af = kh[kk];
        else a_frag<KS>(a, kw, kk, lane);
        ldsm_x4(b, baddr + gq * 16 * KS + kk * 16);
        mma_bf16(st[0], af, b[0], b[1]);
        mma_bf16(st[1], af, b[2], b[3]);
        if constexpr (kHold) af = vh[kk];
        else a_frag<KS>(a, vw, kk, lane);
        ldsm_x4(b, baddr + (kTile + gq * 16) * KS + kk * 16);
        mma_bf16(dpt[0], af, b[0], b[1]);
        mma_bf16(dpt[1], af, b[2], b[3]);
      }
      // P^T = exp(scale s + bias - lse) where the mask allows the pair, 0 by
      // selection elsewhere; dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * gq + 8 * j + 2 * t4 + e;    // the query's place in the tile
          const int lo = lo_s[sl][c], hi = hi_s[sl][c];
          const float l = lse_s[sl][c], dl = delta_s[sl][c];
          const float pa = ok_a && ka >= lo && ka < hi ? expf(st[j][e] * scale + bias_a - l) : 0.f;
          const float pb = ok_b && kb >= lo && kb < hi ? expf(st[j][2 + e] * scale + bias_b - l) : 0.f;
          st[j][e] = pa;
          st[j][2 + e] = pb;
          dpt[j][e] = pa * (dpt[j][e] - dl);
          dpt[j][2 + e] = pb * (dpt[j][2 + e] - dl);
        }
      }
      // dV += P^T.dO and dK += dS^T.q: the group is one k-step of each
      uint32_t hi[4], lo[4];
      c_to_a(st, hi, lo);
      mma_trans<DN>(dva, hi, lo, taddr + (kTile + gq * 16) * KS);
      c_to_a(dpt, hi, lo);
      mma_trans<DN>(dka, hi, lo, taddr + gq * 16 * KS);
    }
    if (t + 1 < n_tiles) {
      meta_store(t + 1);      // its stage's tile t - 1 is done: the barrier above
      if (t + 2 < n_tiles) meta_load(t + 2);
    }
    __syncthreads();   // every warp is done with this stage before tile t + kStages is staged into it
  }

  // dk = scale dS^T q, dv = P^T dO; keys no query sees store their zeros
  __nv_bfloat16* kbo = dk + (size_t)bh * s * d;
  __nv_bfloat16* vbo = dv + (size_t)bh * s * d;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ka < s) {
      store_pair(kbo, ka, c, d, dka[n][0] * scale, dka[n][1] * scale);
      store_pair(vbo, ka, c, d, dva[n][0], dva[n][1]);
    }
    if (kb < s) {
      store_pair(kbo, kb, c, d, dka[n][2] * scale, dka[n][3] * scale);
      store_pair(vbo, kb, c, d, dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------- launch

// Blocks per SM the grids aim at. dq as the forward: causal rows share the
// key prefix the block stages, so fewer, larger blocks (one per SM); a
// media row's image is mostly its own warp's, so more, smaller blocks (two).
// dkv two for either mask: one per SM took the causal dkv 5% longer at MMC4
// T256 (`chip_profile.py k45b`), its first key blocks walking four query
// tiles while the last walk one.
template <typename Mask>
constexpr int kFill = 2;
template <>
constexpr int kFill<CausalPadAlibi> = 1;
constexpr int kFillDkv = 2;

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

// f(DP) for Dh padded to the tensor-core body's 16, 32, 64, 80, 96 or 128 columns
template <typename F>
cudaError_t with_dp(int d, F f) {
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 80) return f(std::integral_constant<int, 80>{});
  if (d <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

template <int DP, typename Mask>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
                          const void* lse, void* delta, void* dq, int bh, int tq, int s, int d, float scale,
                          cudaStream_t st, Mask mask) {
  cudaError_t err = allow_smem<attention_bwd_dq_mma<DP, Mask>>(kStages * stage_bytes<DP>());
  if (err != cudaSuccess) return err;
  int blocks, warps;
  block_shape(tq, bh, kFill<Mask>, kMaxWarps, &blocks, &warps);
  const int stages = ring_stages(s);
  const size_t smem = stages * stage_bytes<DP>() + (stages == kStages ? 0 : own_bytes<DP>(warps));
  const bool vec = d % 8 == 0 && aligned16({q, k, v, out, dout});
  using bf = __nv_bfloat16;
  attention_bwd_dq_mma<DP, Mask><<<dim3(bh, blocks), warps * 32, smem, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)out, (const bf*)dout, (const float*)lse,
      (float*)delta, (bf*)dq, tq, s, d, scale, vec, mask);
  return cudaGetLastError();
}

template <int DP, typename Mask>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh, int tq, int s, int d, float scale,
                           cudaStream_t st, Mask mask) {
  cudaError_t err = allow_smem<attention_bwd_dkv_mma<DP, Mask>>(kStages * stage_bytes<DP>() +
                                                                own_bytes<DP>(kMaxWarps));
  if (err != cudaSuccess) return err;
  int blocks, warps;
  block_shape(s, bh, kFillDkv, kMaxWarps, &blocks, &warps);
  const size_t smem = ring_stages(tq) * stage_bytes<DP>() + own_bytes<DP>(warps);
  const bool vec = d % 8 == 0 && aligned16({q, k, v, dout});
  using bf = __nv_bfloat16;
  attention_bwd_dkv_mma<DP, Mask><<<dim3(bh, blocks), warps * 32, smem, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, (const float*)lse, (const float*)delta,
      (bf*)dk, (bf*)dv, tq, s, d, scale, vec, mask);
  return cudaGetLastError();
}

bool bad_args(int d, int dtype) { return d < 1 || d > kMaxD || (dtype != 0 && dtype != 1); }

// bf16 takes the tensor-core body unless `fma`; fp32 always the FMA body
template <typename Mask>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, void* delta, void* dq, int bh, int tq, int s, int d, float scale,
              int dtype, bool fma, void* stream, Mask mask) {
  if (bad_args(d, dtype)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && !fma) {
    if (tq > 16 * 65535) return (int)cudaErrorInvalidValue;
    return (int)with_dp(d, [&](auto dp) {
      return launch_dq_mma<decltype(dp)::value>(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, st, mask);
    });
  }
  dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  if (dtype == 0) {
    attention_bwd_dq_kernel<float, Mask><<<grid, kThreads, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)out, (const float*)dout,
        (const float*)lse, (float*)delta, (float*)dq, tq, s, d, scale, mask);
  } else {
    using bf = __nv_bfloat16;
    attention_bwd_dq_kernel<bf, Mask><<<grid, kThreads, 0, st>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)out, (const bf*)dout,
        (const float*)lse, (float*)delta, (bf*)dq, tq, s, d, scale, mask);
  }
  return (int)cudaGetLastError();
}

template <typename Mask>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int tq, int s, int d, float scale,
               int dtype, bool fma, void* stream, Mask mask) {
  if (bad_args(d, dtype)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && !fma) {
    if (s > 16 * 65535) return (int)cudaErrorInvalidValue;
    return (int)with_dp(d, [&](auto dp) {
      return launch_dkv_mma<decltype(dp)::value>(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, st, mask);
    });
  }
  dim3 grid(bh, (s + kBKV - 1) / kBKV);
  if (dtype == 0) {
    attention_bwd_dkv_kernel<float, Mask><<<grid, kThreads, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, tq, s, d, scale, mask);
  } else {
    using bf = __nv_bfloat16;
    attention_bwd_dkv_kernel<bf, Mask><<<grid, kThreads, 0, st>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, (const float*)lse,
        (const float*)delta, (bf*)dk, (bf*)dv, tq, s, d, scale, mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K4b. q/out/dout/dq (BH, Tq, D); k/v/dk/dv (BH, S, D); pad (BH, S) uint8;
// slopes (BH,) fp32; lse and delta (BH, Tq) fp32 (delta written by the dq
// launch, read by the dkv launch). dtype 0 = fp32 (CUDA cores), 1 = bf16
// (tensor cores). D <= 128.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* pad, const void* slopes, const void* out,
                                      const void* dout, const void* lse, void* delta, void* dq,
                                      int bh, int tq, int s, int d, int q_offset, int causal,
                                      float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, false, stream, mask);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* pad, const void* slopes, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       int bh, int tq, int s, int d, int q_offset, int causal,
                                       float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, false, stream, mask);
}

// K5b. As K4b with text_time (BH, Tq) int32 in place of pad/slopes/q_offset.
extern "C" int masked_xattn_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* text_time, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq, int bh, int tq, int s,
                                   int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, false, stream, mask);
}

extern "C" int masked_xattn_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* text_time, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh, int tq, int s,
                                    int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, false, stream, mask);
}

// The FMA body in either dtype, with the arguments above: the CUDA-core
// kernels the bf16 tensor-core body replaced, kept as their yardstick.
extern "C" int flash_attention_bwd_dq_fma(const void* q, const void* k, const void* v,
                                          const void* pad, const void* slopes, const void* out,
                                          const void* dout, const void* lse, void* delta, void* dq,
                                          int bh, int tq, int s, int d, int q_offset, int causal,
                                          float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, true, stream, mask);
}

extern "C" int flash_attention_bwd_dkv_fma(const void* q, const void* k, const void* v,
                                           const void* pad, const void* slopes, const void* dout,
                                           const void* lse, const void* delta, void* dk, void* dv,
                                           int bh, int tq, int s, int d, int q_offset, int causal,
                                           float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, true, stream, mask);
}

extern "C" int masked_xattn_bwd_dq_fma(const void* q, const void* k, const void* v,
                                       const void* text_time, const void* out, const void* dout,
                                       const void* lse, void* delta, void* dq, int bh, int tq, int s,
                                       int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, true, stream, mask);
}

extern "C" int masked_xattn_bwd_dkv_fma(const void* q, const void* k, const void* v,
                                        const void* text_time, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int bh, int tq, int s,
                                        int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, true, stream, mask);
}
