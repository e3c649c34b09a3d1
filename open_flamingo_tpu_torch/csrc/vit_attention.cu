// K9 ViT attention for Hopper (sm_90a): bidirectional whole-sequence
// attention of every (image, head) instance, fp32 softmax, the scores kept
// on chip.
//
//   replaces open_flamingo_tpu/ops/vit_attention.py `vit_attention` (kernel
//   `_vit_attn_kernel` via `_vit_attention_fwd_impl`).
//
// Semantics, the TPU kernel's: q is multiplied by `scale` in fp32 and
// rounded to q's dtype; scores q.k^T in fp32; keys at or past S masked
// before the max; P = exp(s - max) divided by its row sum in fp32, then
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
// Design and bound. At ViT-L/14 (S 257, Dh 64) an instance's q/k/v/out are
// 132 KB in bf16 and its attention 17 MFLOP: ~130 FLOP per byte, under the
// H100's ~295, so the bytes over 3.35 TB/s are the floor, with the FLOPs
// over 989 TFLOP/s close behind. The einsum route writes the fp32 score
// matrix (S x S per instance) to device memory and reads it back several
// times; here it never leaves registers. One block per (instance, block of
// query rows): the instance's K and V are staged in shared memory by
// `cp.async` (every 16-byte copy of the block in flight at once, no
// register round trip), padded to S_pad = ceil(S / 16) * 16 keys (zeros
// past S), and each warp owns 16 query rows.
//
// * bf16: tensor cores, `mma.sync` m16n8k16 with fp32 accumulation. The
//   warp's q rows are A fragments loaded straight from device memory (scaled
//   and rounded there); the scores of its 16 rows against all S_pad keys
//   stay in the accumulators (S_pad / 8 tiles of 16 x 8); the row max and
//   sum are shuffles across the 4 lanes that share a row; the normalised P,
//   rounded to bf16, is already in the A-fragment layout of P.V (the
//   accumulator tiles of keys 16t..16t+15 are the A operand of k-step t), so
//   P never goes through shared memory. The B fragments come from shared
//   memory by `ldmatrix` (K as it is, V transposed by `.trans`), four 8 x 8
//   tiles per instruction; K and V rows are padded by 8 elements, so the
//   eight rows of each tile fall in 32 distinct banks. The products of bf16
//   values are exact in fp32; only the order of the sums differs from the
//   plain version.
// * fp32: CUDA cores (no TF32, which keeps ~3 digits): each warp takes its
//   block's query rows one at a time, lane j scores keys j, j + 32, ... from
//   K in shared memory (rows padded by one word: conflict-free), the warp
//   reduces max and sum by shuffles, writes P to shared memory, and each
//   lane sums P.V for its columns of the row.
// Blocks take 16 * warps query rows; the warps per block are chosen so that
// S's 16-row tiles spread evenly over at most 6 warps in bf16 (8 in fp32):
// S 257 has 17 tiles, 3 blocks of 6 warps, so K and V are staged 3 times per
// instance, from L2. The bf16 kernel is held to 170 registers so that two
// blocks share an SM: with one (its first versions, 194 registers) its
// warps waited on their own latencies, 1.3-1.6x slower on the card.
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
// of its value, exact products, fp32 sums), two `mma.sync` per fragment
// where K9 rounds P once. Its scores stay live through P.V, so the bf16
// instance runs one block per SM (no 170-register cap). Bound at OF-3B's
// B' 8 (S_pad 264, s_real 257, 16 heads of Dh 64): 17.3 MB of q/k/v/out
// over 3.35 TB/s, 0.0052 ms, above 2.2 GFLOP over 989 TFLOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int kMaxS = 272;                 // keys on chip per row: 17 tiles of 16
constexpr int kKeyTiles = kMaxS / 16;
constexpr int kMaxWarps = 8;               // fp32 blocks
constexpr int kBf16Warps = 6;              // bf16 blocks: two per SM in 170 registers
constexpr int kMaxD = 64;

struct Strides {
  long long b, h, s;  // element strides of batch, head and row; Dh contiguous
};

struct Operand {
  const void* p;
  Strides st;
};

// ---------------------------------------------------------------- bf16

// two bf16 of a q row, times scale in fp32, rounded back to bf16
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* p, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * scale, f.y * scale);
}

template <int D>
__host__ __device__ constexpr int k_stride() { return D + 8; }  // bf16 elements per staged K or V row

template <int D>
size_t smem_bf16(int s_pad) {
  return 2 * (size_t)s_pad * k_stride<D>() * 2;
}

// Fragment layouts: mma_frag.cuh, whose helpers (mma_bf16, ldsm_x4, ...)
// these kernels share with prefill_attention.cu.
// kFlat (K8): s query rows, the first s_keys of them keys; otherwise (K9)
// s_keys is not read and all s rows are keys.
template <int D, bool kFlat>
__global__ void __launch_bounds__(kBf16Warps * 32, kFlat ? 1 : 2) vit_attn_bf16(
    Operand q, Operand k, Operand v, __nv_bfloat16* __restrict__ out, Strides ost, int nh, int s,
    float scale, int s_keys) {
  constexpr int DK = D / 16;   // k-steps of q.k^T
  constexpr int DN = D / 8;    // n-tiles of P.V
  constexpr int KS = k_stride<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int sk = kFlat ? s_keys : s;
  const int s_pad = (sk + 15) & ~15;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [s_pad][KS]
  __nv_bfloat16* v_s = k_s + (size_t)s_pad * KS;                   // [s_pad][KS]

  const int inst = blockIdx.y, b = inst / nh, h = inst % nh;
  const __nv_bfloat16* qp = (const __nv_bfloat16*)q.p + b * q.st.b + h * q.st.h;
  const __nv_bfloat16* kp = (const __nv_bfloat16*)k.p + b * k.st.b + h * k.st.h;
  const __nv_bfloat16* vp = (const __nv_bfloat16*)v.p + b * v.st.b + h * v.st.h;
  __nv_bfloat16* op = out + b * ost.b + h * ost.h;

  // stage K and V, 16 bytes of a row per copy, zeros past S
  for (int idx = threadIdx.x; idx < s_pad * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool real = r < sk;
    cp_async16(k_s + r * KS + c, real ? kp + r * k.st.s + c : kp, real);
    cp_async16(v_s + r * KS + c, real ? vp + r * v.st.s + c : vp, real);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;
  const int ra = row0 + g, rb = row0 + g + 8;

  // q A fragments, scaled and rounded (K8: as they are), loaded while the
  // copies land; rows past S are zeros
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = kk * 16 + 2 * t4;
    if constexpr (kFlat) {
      qa[kk][0] = ra < s ? *reinterpret_cast<const uint32_t*>(qp + ra * q.st.s + c) : 0u;
      qa[kk][1] = rb < s ? *reinterpret_cast<const uint32_t*>(qp + rb * q.st.s + c) : 0u;
      qa[kk][2] = ra < s ? *reinterpret_cast<const uint32_t*>(qp + ra * q.st.s + c + 8) : 0u;
      qa[kk][3] = rb < s ? *reinterpret_cast<const uint32_t*>(qp + rb * q.st.s + c + 8) : 0u;
    } else {
      qa[kk][0] = ra < s ? scaled_pair(qp + ra * q.st.s + c, scale) : 0u;
      qa[kk][1] = rb < s ? scaled_pair(qp + rb * q.st.s + c, scale) : 0u;
      qa[kk][2] = ra < s ? scaled_pair(qp + ra * q.st.s + c + 8, scale) : 0u;
      qa[kk][3] = rb < s ? scaled_pair(qp + rb * q.st.s + c + 8, scale) : 0u;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (row0 >= s) return;
  // the row of tile l / 8 that lane l addresses in `ldmatrix`
  const int lr = lane % 8, lt = lane / 8;

  // scores: sc[t][j] is the 16 x 8 tile of keys 16t + 8j .. 16t + 8j + 7
  const int n_tiles = s_pad / 16;
  float sc[kKeyTiles][2][4];
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    if (t < n_tiles) {
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[t][j][0] = sc[t][j][1] = sc[t][j][2] = sc[t][j][3] = 0.f;
      // tiles: keys 16t..16t+7 at columns 16kk and 16kk + 8, then keys 16t+8..16t+15
      const __nv_bfloat16* kaddr = k_s + (t * 16 + (lt >> 1) * 8 + lr) * KS + (lt & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kaddr + kk * 16);
        mma_bf16(sc[t][0], qa[kk], b[0], b[1]);
        mma_bf16(sc[t][1], qa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* c = sc[t][j];
        if constexpr (kFlat) {
          c[0] *= scale;
          c[1] *= scale;
          c[2] *= scale;
          c[3] *= scale;
        }
        const int col = t * 16 + j * 8 + 2 * t4;
        if (col >= sk) c[0] = c[2] = -INFINITY;
        if (col + 1 >= sk) c[1] = c[3] = -INFINITY;
        mx_a = fmaxf(mx_a, fmaxf(c[0], c[1]));
        mx_b = fmaxf(mx_b, fmaxf(c[2], c[3]));
      }
    }
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);   // every row has a valid key: finite

  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    if (t < n_tiles) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* c = sc[t][j];
        c[0] = expf(c[0] - mx_a);   // masked keys: exp(-inf) = 0
        c[1] = expf(c[1] - mx_a);
        c[2] = expf(c[2] - mx_b);
        c[3] = expf(c[3] - mx_b);
        sum_a += c[0] + c[1];
        sum_b += c[2] + c[3];
      }
    }
  }
  sum_a = quad_sum(sum_a);
  sum_b = quad_sum(sum_b);

  // P normalised in fp32, rounded to bf16 into the A fragments of P.V, all
  // before P.V: the fp32 scores die here, so they and the accumulators of
  // P.V are never live together (K8 keeps the scores: see the note above)
  uint32_t pa[kFlat ? 1 : kKeyTiles][4];
  if constexpr (!kFlat) {
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      if (t < n_tiles) {
        pa[t][0] = pack_bf16(sc[t][0][0] / sum_a, sc[t][0][1] / sum_a);
        pa[t][1] = pack_bf16(sc[t][0][2] / sum_b, sc[t][0][3] / sum_b);
        pa[t][2] = pack_bf16(sc[t][1][0] / sum_a, sc[t][1][1] / sum_a);
        pa[t][3] = pack_bf16(sc[t][1][2] / sum_b, sc[t][1][3] / sum_b);
      }
    }
  }
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    if (t < n_tiles) {
      // tiles: keys 16t..16t+7 and 16t+8..16t+15 at columns 8n, then at 8n + 8
      const __nv_bfloat16* vaddr = v_s + (t * 16 + (lt & 1) * 8 + lr) * KS + (lt >> 1) * 8;
      if constexpr (kFlat) {
        // fragment i: tile j = i / 2 of keys, row a (i even) or b (i odd)
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* c = sc[t][i >> 1] + (i & 1) * 2;
          const float den = (i & 1) ? sum_b : sum_a;
          split_bf16(c[0] / den, c[1] / den, &hi[i], &lo[i]);
        }
#pragma unroll
        for (int n = 0; n < DN; n += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, vaddr + n * 8);
          mma_bf16(o[n], hi, b[0], b[1]);
          mma_bf16(o[n], lo, b[0], b[1]);
          mma_bf16(o[n + 1], hi, b[2], b[3]);
          mma_bf16(o[n + 1], lo, b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < DN; n += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, vaddr + n * 8);
          mma_bf16(o[n], pa[t], b[0], b[1]);
          mma_bf16(o[n + 1], pa[t], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ra < s) *reinterpret_cast<uint32_t*>(op + ra * ost.s + c) = pack_bf16(o[n][0], o[n][1]);
    if (rb < s) *reinterpret_cast<uint32_t*>(op + rb * ost.s + c) = pack_bf16(o[n][2], o[n][3]);
  }
}

// ---------------------------------------------------------------- fp32

constexpr int kKeysPerLane = (kMaxS + 31) / 32;

size_t smem_f32(int s, int d, int warps) {
  return ((size_t)s * (d + 1) + (size_t)s * d + (size_t)warps * (kMaxD + kMaxS)) * 4;
}

// kFlat: as vit_attn_bf16's
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

// s query rows; with kFlat the first s_keys of them are the keys
template <int D, bool kFlat>
cudaError_t launch_bf16(Operand q, Operand k, Operand v, void* out, Strides ost, int nb, int nh,
                        int s, float scale, int s_keys, cudaStream_t st) {
  int blocks, warps;
  block_shape(s, kBf16Warps, &blocks, &warps);
  const dim3 grid(blocks, nb * nh);
  cudaError_t err = allow_smem<vit_attn_bf16<D, kFlat>>(smem_bf16<D>(kMaxS));
  if (err != cudaSuccess) return err;
  const int sk = kFlat ? s_keys : s;
  vit_attn_bf16<D, kFlat><<<grid, warps * 32, smem_bf16<D>((sk + 15) & ~15), st>>>(
      q, k, v, (__nv_bfloat16*)out, ost, nh, s, scale, s_keys);
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
