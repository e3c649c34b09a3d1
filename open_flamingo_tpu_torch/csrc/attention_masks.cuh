// Mask policies and element helpers shared by the prefill attention
// kernels (forward, prefill_attention.cu) and their backward
// (attention_backward.cu). Everything here has internal linkage: each .cu
// is its own shared library, loaded into one process.
//
//   CausalPadAlibi  K4/K4b: causal against q_offset + i, key pad mask,
//                   ALiBi slope * (j - (S - 1)) computed from the index.
//   MediaTime       K5/K5b: the immediate-media mask
//                   text_time[i] == j / n_latents + 1.
//
// The FMA bodies ask `allowed` of every (row, key) pair. The tensor-core
// forward (prefill_attention.cu) asks each row once for the interval of
// keys it may see (`row_keys`: [lo, hi), empty when hi <= lo), which also
// bounds the key tiles a block loads, and each key once whether it is
// valid for every row (`key_valid`, the pad mask: nonzero = valid); a pair
// is allowed when its key is valid and inside its row's interval, the same
// set as `allowed`. `slope` is the factor of the bias (0: none).
//
// The tensor-core backward (attention_backward.cu) asks the same of its
// rows, and its dk/dv kernel asks the reverse once per block: the queries
// [lo, hi) that may see a key of the block's [k0, k1) (`key_queries`),
// which bound the query tiles it walks. Causal: from the first query that
// sees k0 on, [max(0, k0 - q_offset), Tq), the same for every thread.
// Media: one scan of the instance's text_time row by the whole block (every
// thread must call it): the first and the last query whose `row_keys` meet
// [k0, k1), exact for any text_time, a cumsum or not; within the interval
// the per-element test (`row_keys` and `key_valid`) still decides.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct CausalPadAlibi {
  const uint8_t* pad;    // (BH, S), nonzero = valid key
  const float* slopes;   // (BH,), 0 disables ALiBi
  int q_offset;
  int causal;

  // keys [0, key_end) are all that query rows up to q_last can see
  __device__ int key_end(int q_last, int s) const {
    return causal ? min(s, q_offset + q_last + 1) : s;
  }
  // no query row before query_begin sees key k0 or a later one
  __device__ int query_begin(int k0) const { return causal ? max(0, k0 - q_offset) : 0; }
  __device__ bool allowed(int bh, int qi, int kj, int s) const {
    return pad[(size_t)bh * s + kj] != 0 && (!causal || kj <= q_offset + qi);
  }
  __device__ float bias(int bh, int kj, int s) const {
    return slopes[bh] * (float)(kj - (s - 1));
  }

  __device__ void row_keys(int, int qi, int s, int* lo, int* hi) const {
    *lo = 0;
    *hi = causal ? min(s, q_offset + qi + 1) : s;
  }
  __device__ int key_valid(int bh, int kj, int s) const { return pad[(size_t)bh * s + kj]; }
  __device__ float slope(int bh) const { return slopes[bh]; }
  __device__ void key_queries(int, int k0, int, int tq, int, int* lo, int* hi) const {
    *lo = causal ? min(tq, max(0, k0 - q_offset)) : 0;
    *hi = tq;
  }
};

struct MediaTime {
  const int32_t* text_time;  // (BH, Tq)
  int n_latents;
  int tq;

  __device__ int key_end(int, int s) const { return s; }
  __device__ int query_begin(int) const { return 0; }
  __device__ bool allowed(int bh, int qi, int kj, int) const {
    return text_time[(size_t)bh * tq + qi] == kj / n_latents + 1;
  }
  __device__ float bias(int, int, int) const { return 0.f; }

  // the keys of image t = text_time[i]: [(t - 1) n_latents, t n_latents);
  // text before the first image (t < 1) sees none
  __device__ void row_keys(int bh, int qi, int s, int* lo, int* hi) const {
    const long long t = text_time[(size_t)bh * tq + qi];
    *lo = t >= 1 ? (int)min((long long)s, (t - 1) * n_latents) : s;
    *hi = t >= 1 ? (int)min((long long)s, t * n_latents) : 0;
  }
  __device__ int key_valid(int, int, int) const { return 1; }
  __device__ float slope(int) const { return 0.f; }
  __device__ void key_queries(int bh, int k0, int k1, int, int s, int* lo, int* hi) const {
    __shared__ int range_s[2];
    int first = tq, last = -1;
    for (int qi = threadIdx.x; qi < tq; qi += blockDim.x) {
      int rlo, rhi;
      row_keys(bh, qi, s, &rlo, &rhi);
      if (max(rlo, k0) < min(rhi, k1)) {
        first = min(first, qi);
        last = qi;
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (threadIdx.x == 0) {
      range_s[0] = tq;
      range_s[1] = -1;
    }
    __syncthreads();
    if (threadIdx.x % 32 == 0) {
      atomicMin(&range_s[0], first);
      atomicMax(&range_s[1], last);
    }
    __syncthreads();
    *lo = range_s[0];
    *hi = range_s[1] + 1;
  }
};

}  // namespace
