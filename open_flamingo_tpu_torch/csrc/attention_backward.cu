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
// dq = scale * dS K walks the key tiles of one (bh, query tile), and
// dk = dS^T (scale * q), dv = P^T dO walk the query tiles of one (bh, key
// tile). Both recompute s; neither materialises it in device memory.
// delta = rowsum(dO * O) is fused into the dq kernel, which writes it for
// the dkv kernel launched after it on the same stream (the JAX package
// computes it outside its Pallas calls). No atomics: each output element
// is one thread's fp32 sum, so results are deterministic.
//
// Exact zeros: a masked (q, k) pair has dS = P = 0 by selection, not by
// exp(-inf), so masked keys get dk = dv = 0 and rows with no valid key get
// dq = 0 exactly, whatever lse holds there (0). Every read is bounded
// (ragged Tq and S; the TPU kernels bound S only in the forward).
//
// Design. Blocks of 128 threads, fp32 FMA over tiles staged in shared
// memory as fp32 (bf16 inputs converted on load), like the forward. dq: 16
// query rows per block, 32-key tiles; V then K of a tile share one buffer
// (dO V^T first, then s and dS), so the block stays under 48 KB of static
// shared memory at Dh = 128. dkv: 16 keys per block, 16-query tiles, dk
// and dv accumulators in registers (16 + 16 per thread at Dh = 128).
// Causal skipping: dq stops at the last key its tile can see; dkv starts
// at the first query tile that can see its keys.
//
// Bound. At the training path's shapes (OF-3B; LAION BH = 128, T = 32; MMC4
// BH = 64, T = 256, Dh = 128; xattn BH = 64/32, S = 64/384, Dh = 64) the
// backward moves a few MB and does 10 * Dh FLOPs per allowed pair, so the
// card's floor is the bytes (microseconds). These first kernels are bound
// by their fp32 FMA loops out of shared memory; tensor cores (wgmma) and
// TMA are a later optimisation.

#include <math.h>

#include "attention_masks.cuh"

namespace {

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

bool bad_args(int d, int dtype) { return d < 1 || d > kMaxD || (dtype != 0 && dtype != 1); }

template <typename Mask>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, void* delta, void* dq, int bh, int tq, int s, int d, float scale,
              int dtype, void* stream, Mask mask) {
  if (bad_args(d, dtype)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaGetLastError();
  dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  cudaStream_t st = (cudaStream_t)stream;
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
               int dtype, void* stream, Mask mask) {
  if (bad_args(d, dtype)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || s == 0) return (int)cudaGetLastError();
  dim3 grid(bh, (s + kBKV - 1) / kBKV);
  cudaStream_t st = (cudaStream_t)stream;
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
// launch, read by the dkv launch). dtype 0 = fp32, 1 = bf16.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* pad, const void* slopes, const void* out,
                                      const void* dout, const void* lse, void* delta, void* dq,
                                      int bh, int tq, int s, int d, int q_offset, int causal,
                                      float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, stream, mask);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* pad, const void* slopes, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       int bh, int tq, int s, int d, int q_offset, int causal,
                                       float scale, int dtype, void* stream) {
  CausalPadAlibi mask{(const uint8_t*)pad, (const float*)slopes, q_offset, causal};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, stream, mask);
}

// K5b. As K4b with text_time (BH, Tq) int32 in place of pad/slopes/q_offset.
extern "C" int masked_xattn_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* text_time, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq, int bh, int tq, int s,
                                   int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dq(q, k, v, out, dout, lse, delta, dq, bh, tq, s, d, scale, dtype, stream, mask);
}

extern "C" int masked_xattn_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* text_time, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh, int tq, int s,
                                    int d, int n_latents, float scale, int dtype, void* stream) {
  if (n_latents < 1) return (int)cudaErrorInvalidValue;
  MediaTime mask{(const int32_t*)text_time, n_latents, tq};
  return launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, tq, s, d, scale, dtype, stream, mask);
}
