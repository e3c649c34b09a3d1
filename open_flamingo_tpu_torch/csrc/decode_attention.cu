// K7 decode attention for Hopper (sm_90a): one query token per sequence
// over the head-major (B, H, S, Dh) cache.
//
//   replaces open_flamingo_tpu/ops/decode_attention.py `_decode_kernel`
//   via `_call`, as both `decode_attention` (static K/V, e.g. the media
//   K/V cached at prefill) and `decode_attention_update` (write the new
//   token's K/V at `slot`, then attend, in one launch).
//
// The update variant MUTATES the cache tensors in place: the TPU kernel
// aliases its cache inputs to its outputs and flushes only the slot's
// block; here each block writes its own (b, h) row at `slot` before it
// reads the cache, and __syncthreads makes that write visible to the rest
// of the block, so the new token takes part in this step's attention.
//
// Masking: a (B, S) validity mask (pad and causality folded in by the
// caller), optional ALiBi slope_h * (j - (S - 1)). A row with no valid key
// produces exact zeros, which the cross-attention decode relies on for
// text before the first image.
//
// Design and bound. Decode attention does 4 FLOPs per cache element it
// reads, far below the ~295 FLOP/byte at which the H100 stops being
// memory-bound, so the cache bytes over 3.35 TB/s are the floor. One block
// of 128 threads per (b, h): each warp streams every 4th cache row (one
// row = Dh contiguous values, read by the 32 lanes together), keeps its own
// running max / sum / accumulator in registers, and the four warps merge
// their partial softmaxes in shared memory at the end. Masked rows are
// never read. At the path's shapes (S = 64) the launch, not the bytes,
// dominates; vectorised loads and a split over S are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kPerLane = kMaxD / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// k/v are not __restrict__ const: the update variant writes them in the
// same launch, so they must not go through the read-only cache path.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, T* k, T* v, const uint8_t* __restrict__ mask,
    const float* __restrict__ slopes, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* __restrict__ out, int h, int s, int d, int slot,
    float scale) {
  __shared__ float q_s[kMaxD];
  __shared__ float m_w[kWarps], l_w[kWarps];
  __shared__ float acc_w[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  T* kb = k + (size_t)bh * s * d;
  T* vb = v + (size_t)bh * s * d;
  const uint8_t* mrow = mask + (size_t)b * s;

  if (k_new != nullptr) {
    for (int c = tid; c < d; c += kThreads) {
      kb[(size_t)slot * d + c] = k_new[(size_t)bh * d + c];
      vb[(size_t)slot * d + c] = v_new[(size_t)bh * d + c];
    }
  }
  for (int c = tid; c < d; c += kThreads) q_s[c] = to_f32(q[(size_t)bh * d + c]) * scale;
  __syncthreads();

  const float slope = slopes != nullptr ? slopes[head] : 0.f;
  float m = -INFINITY, l = 0.f, acc[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) acc[r] = 0.f;

  for (int j = warp; j < s; j += kWarps) {
    if (mrow[j] == 0) continue;  // uniform across the warp
    const T* krow = kb + (size_t)j * d;
    float dot = 0.f;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      int c = lane + 32 * r;
      if (c < d) dot = fmaf(q_s[c], to_f32(krow[c]), dot);
    }
    float sc = warp_sum(dot) + slope * (float)(j - (s - 1));
    float m_new = fmaxf(m, sc);
    float alpha = expf(m - m_new);  // first valid key: exp(-inf) = 0
    float p = expf(sc - m_new);
    l = l * alpha + p;
    const T* vrow = vb + (size_t)j * d;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      int c = lane + 32 * r;
      if (c < d) acc[r] = fmaf(p, to_f32(vrow[c]), acc[r] * alpha);
    }
    m = m_new;
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    int c = lane + 32 * r;
    if (c < d) acc_w[warp][c] = acc[r];
  }
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w]);
  for (int c = tid; c < d; c += kThreads) {
    float o = 0.f;
    if (mx != -INFINITY) {
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        float f = expf(m_w[w] - mx);  // warps with no valid key: 0
        num = fmaf(acc_w[w][c], f, num);
        den = fmaf(l_w[w], f, den);
      }
      o = num / den;
    }
    store(&out[(size_t)bh * d + c], o);
  }
}

}  // namespace

// q (B, H, D); k/v (B, H, S, D); mask (B, S) uint8; slopes (H,) fp32 or
// NULL; k_new/v_new (B, H, D) or NULL (no update); out (B, H, D).
// dtype 0 = fp32, 1 = bf16.
extern "C" int decode_attention_fwd(const void* q, void* k, void* v, const void* mask,
                                    const void* slopes, const void* k_new, const void* v_new,
                                    void* out, int b, int h, int s, int d, int slot, float scale,
                                    int dtype, void* stream) {
  if (d < 1 || d > kMaxD || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if ((k_new == nullptr) != (v_new == nullptr)) return (int)cudaErrorInvalidValue;
  if (k_new != nullptr && (slot < 0 || slot >= s)) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    decode_kernel<float><<<b * h, kThreads, 0, st>>>(
        (const float*)q, (float*)k, (float*)v, (const uint8_t*)mask, (const float*)slopes,
        (const float*)k_new, (const float*)v_new, (float*)out, h, s, d, slot, scale);
  } else {
    decode_kernel<__nv_bfloat16><<<b * h, kThreads, 0, st>>>(
        (const __nv_bfloat16*)q, (__nv_bfloat16*)k, (__nv_bfloat16*)v, (const uint8_t*)mask,
        (const float*)slopes, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (__nv_bfloat16*)out, h, s, d, slot, scale);
  }
  return (int)cudaGetLastError();
}
