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
// backward kernels K4b/K5b (attention_backward.cu) re-exponentiate against.
// The mask policies live in attention_masks.cuh, shared with the backward.
//
// Design. One block of 128 threads per (bh, tile of 16 query rows). The
// TPU kernels carry the running max / sum / accumulator across the
// sequential K grid axis in VMEM scratch; here a loop inside the block
// walks 32-key tiles staged in shared memory (fp32), and the running
// state lives in registers (accumulator) and shared memory (max, sum).
// Causal tiles wholly above the diagonal are never loaded.
//
// Bound. At the serving path's shapes (B*H = 128 or 64 rows of 32 queries,
// S = 64 keys, Dh = 128 or 64) the work is ~0.1 GFLOP over ~4 MB, so the
// card's floor is the bytes (about 1 us); the kernel itself is bound by
// its fp32 FMA loops and launch latency. This first version uses plain
// FMA, not tensor cores: wgmma/TMA tiles are a later optimisation.

#include <math.h>

#include "attention_masks.cuh"

namespace {

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

template <typename Mask>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
           int s, int d, float scale, int dtype, void* stream, Mask mask) {
  if (d < 1 || d > kMaxD || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaGetLastError();
  dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  cudaStream_t st = (cudaStream_t)stream;
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
// out (BH, Tq, D); lse (BH, Tq) fp32 or null. dtype 0 = fp32, 1 = bf16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, const void* slopes, void* out, void* lse,
                                   int bh, int tq, int s, int d, int q_offset, int causal,
                                   float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, stream, mask);
}

// q (BH, Tq, D); k/v (BH, T_img * n_latents, D); text_time (BH, Tq) int32;
// lse (BH, Tq) fp32 or null.
extern "C" int masked_xattn_fwd(const void* q, const void* k, const void* v,
                                const void* text_time, void* out, void* lse, int bh, int tq,
                                int s, int d, int n_latents, float scale, int dtype,
                                void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch(q, k, v, out, lse, bh, tq, s, d, scale, dtype, stream, mask);
}
