// The attend body of K3 / K6 (csrc/decode_layer.cu) and of K11's attention
// phase (csrc/fused_layer.cu): one (b, h) of a single-token decode step's
// masked softmax over a (B, H_kv, S, Dh) cache, with the new token's K/V
// written at `slot` in place. See decode_layer.cu for what it computes and
// attend_body below for how.
//
// K3 and K6 launch it as one 128-thread block per (b, h) (kAttnThreads),
// its scores in dynamic shared memory and its other arrays static
// (attend_body). A persistent kernel calls it with its own (b, h) index from
// a larger block (kBlockThreads) and its own shared memory (attend_at,
// AttendSmem): threads past the first 128 take no keys, rows or columns and
// only reach the barriers. With kCg the fp32 projection that an earlier
// phase of the same launch wrote is read through L2 alone.

#pragma once

#include "rows_gemv.cuh"

namespace {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxD = 128;
constexpr int kBatch = 8;     // global loads a thread issues before it uses them
constexpr int kMaxS = 8192;  // the scores of one (b, h), 32 KB, fit the default shared memory
constexpr int kIdle = 1 << 30;  // the thread index of a persistent block's threads past kAttnThreads

using rows::from_f32;
using rows::to_f32;

template <int kBlockThreads = kAttnThreads>
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free (an earlier reduction has been read)
  if (lane == 0 && (kBlockThreads == kAttnThreads || warp < kAttnWarps)) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kAttnWarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// 8 consecutive cache elements (T, or int8) to fp32. Plain loads: this
// launch writes the cache.
template <typename C>
__device__ __forceinline__ void load8c(const C* p, float* v) {
  if constexpr (std::is_same<C, int8_t>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = rows::small_int_to_f32(rows::sbyte(u.x, e));
      v[4 + e] = rows::small_int_to_f32(rows::sbyte(u.y, e));
    }
  } else {
    rows::load8<false>(p, v);
  }
}

// one fp32 element of the projection; kCg: through L2 alone
template <bool kCg>
__device__ __forceinline__ float load_proj(const float* p) {
  if constexpr (kCg) return __ldcg(p);
  else return *p;
}

// Where a block finds its query and the new token's K/V row:
//  * K3: the fp32 projection `proj` (B, p), q at [0, H*Dh), the new K at
//    [H*Dh, 2*H*Dh), V after; q is scaled here and nothing is rounded
//    before the attend (the TPU kernel attends to the unrounded K/V);
//  * K6: q (B, H, Dh) unscaled, k_new/v_new (B, H_kv, Dh), all in T; q is
//    scaled and rounded to T here (the TPU kernel's pre-scaled q operand),
//    the new K/V are the values the cache keeps, and the step attends to
//    them.
template <typename T>
struct NewToken {
  const float* proj;
  int p;
  const T* q;
  const T* kn;
  const T* vn;
};

// Where the attend keeps its arrays: the scores (S floats), q and the new
// K/V (kMaxD each), the reduction's partials (kAttnWarps) and the output's
// (kAttnThreads * 8). `part` may lie over the scores (kPartOverScores: the
// block waits until every score is read before writing it).
struct AttendSmem {
  float *sc, *q_s, *kn_s, *vn_s, *red, *part;
};
constexpr int kAttendStatics = 3 * kMaxD + kAttnWarps;  // floats of q_s, kn_s, vn_s and red

// (b, h) = (bh / h, bh % h). k/v caches (B, H_kv, S, Dh) of C (T, or int8
// with row scales ks/vs (B, H_kv, S) fp32), query head `head` reading kv
// head head / (H / H_kv); attn (B, H*Dh). slot == nullptr: no new K/V (the
// q-only form). k/v/ks/vs are not __restrict__ const: this launch writes
// them (with H_kv < H, every query head of a group writes the same values).
// Key-parallel: thread j scores key j (its K row read with batched 16-byte
// loads, valid or not), the block reduces max and sum, then groups of d / 8
// threads sum p_j * V[j] over their share of the keys. A few rounds of
// independent loads, where a serial online softmax chains three dependent
// loads per key.
// kLoads: the loads a thread has in flight (K11 holds fewer, within its
// register budget; the sums add in the same order either way)
template <typename T, typename C, int kBlockThreads, bool kCg, bool kPartOverScores, int kLoads = kBatch>
__device__ __forceinline__ void attend_at(
    int bh, const NewToken<T>& src, C* k, C* v, float* ks, float* vs, const uint8_t* __restrict__ mask,
    const float* __restrict__ slopes, const int* __restrict__ slot_ptr, T* __restrict__ attn, int h,
    int h_kv, int s, int d, float scale, const AttendSmem& m) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  float *sc = m.sc, *q_s = m.q_s, *kn_s = m.kn_s, *vn_s = m.vn_s, *red = m.red, *part = m.part;

  const int b = bh / h, head = bh % h;
  const int inner = h * d;
  const int tid = kBlockThreads == kAttnThreads || threadIdx.x < kAttnThreads ? threadIdx.x : kIdle;
  const size_t kv_row = (size_t)b * h_kv + head / (h / h_kv);
  C* kb = k + kv_row * s * d;
  C* vb = v + kv_row * s * d;
  const uint8_t* mrow = mask + (size_t)b * s;

  int slot = -1;
  if (slot_ptr != nullptr) {
    slot = *slot_ptr;
    if (slot < 0 || slot >= s) slot = -1;  // the caller checks the range on the host
  }
  for (int c = tid; c < d; c += kAttnThreads) {
    if (src.proj != nullptr) {
      const float* prow = src.proj + (size_t)b * src.p + (size_t)head * d;
      q_s[c] = load_proj<kCg>(&prow[c]) * scale;
      if (slot >= 0) {
        kn_s[c] = load_proj<kCg>(&prow[inner + c]);
        vn_s[c] = load_proj<kCg>(&prow[2 * inner + c]);
      }
    } else {
      q_s[c] = to_f32(from_f32<T>(to_f32(src.q[(size_t)bh * d + c]) * scale));
      if (slot >= 0) {
        kn_s[c] = to_f32(src.kn[kv_row * d + c]);
        vn_s[c] = to_f32(src.vn[kv_row * d + c]);
      }
    }
    if constexpr (!kInt8) {
      if (slot >= 0) {
        kb[(size_t)slot * d + c] = from_f32<T>(kn_s[c]);
        vb[(size_t)slot * d + c] = from_f32<T>(vn_s[c]);
      }
    }
  }
  // int8 cache: quantize the new token's rows (the slot's scales sk, sv);
  // kn_s/vn_s then hold the quantized values this step attends to
  float sk = 1.f, sv = 1.f;
  if constexpr (kInt8) {
    if (slot >= 0) {  // uniform across the block
      float ka = 0.f, va = 0.f;
      for (int c = tid; c < d; c += kAttnThreads) {
        ka = fmaxf(ka, fabsf(kn_s[c]));
        va = fmaxf(va, fabsf(vn_s[c]));
      }
      ka = block_reduce<kBlockThreads>(ka, red, true);
      va = block_reduce<kBlockThreads>(va, red, true);
      sk = ka == 0.f ? 1.f : ka / 127.f;
      sv = va == 0.f ? 1.f : va / 127.f;
      for (int c = tid; c < d; c += kAttnThreads) {
        kn_s[c] = fminf(fmaxf(rintf(kn_s[c] / sk), -127.f), 127.f);
        vn_s[c] = fminf(fmaxf(rintf(vn_s[c] / sv), -127.f), 127.f);
        kb[(size_t)slot * d + c] = (int8_t)kn_s[c];
        vb[(size_t)slot * d + c] = (int8_t)vn_s[c];
      }
      if (tid == 0) {
        ks[kv_row * s + slot] = sk;
        vs[kv_row * s + slot] = sv;
      }
    }
  }
  __syncthreads();

  // scores; the new token attends to its K/V as staged above
  const float slope = slopes != nullptr ? slopes[head] : 0.f;
  float mx = -INFINITY;
  for (int j = tid; j < s; j += kAttnThreads) {
    // every row is read, so the loads do not wait for the mask; a masked
    // row's score (from a row never written) is selected away
    const C* kr = kb + (size_t)j * d;
    float dot = 0.f;
    for (int c0 = 0; c0 < d; c0 += kLoads * rows::kVec) {  // kLoads loads in flight
      float kv[kLoads][rows::kVec];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (c0 + u * rows::kVec < d) load8c(kr + c0 + u * rows::kVec, kv[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (c0 + u * rows::kVec < d)
#pragma unroll
          for (int e = 0; e < rows::kVec; ++e) dot = fmaf(q_s[c0 + u * rows::kVec + e], kv[u][e], dot);
    }
    if (j == slot) {
      dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(q_s[c], kn_s[c], dot);
    }
    if constexpr (kInt8) dot *= j == slot ? sk : ks[kv_row * s + j];  // dequantized logit
    const float sj = mrow[j] != 0 ? dot + slope * (float)(j - (s - 1)) : -INFINITY;
    sc[j] = sj;
    mx = fmaxf(mx, sj);
  }
  mx = block_reduce<kBlockThreads>(mx, red, true);

  float l = 0.f;
  for (int j = tid; j < s; j += kAttnThreads) {
    float pj = sc[j] == -INFINITY ? 0.f : expf(sc[j] - mx);  // all masked: every pj = 0
    l += pj;
    if constexpr (kInt8) pj *= j == slot ? sv : vs[kv_row * s + j];  // dequantized softmax weight
    sc[j] = pj;
  }
  l = block_reduce<kBlockThreads>(l, red, false);  // its barriers also publish sc

  // output: thread (grp, oct) sums p_j * V[j][8 oct .. 8 oct + 7] over keys
  // grp, grp + G, ...: 16-byte loads (8-byte for int8), a row read by d / 8
  // neighbouring threads, kLoads rows in flight. The loads are
  // unconditional; a masked key's row (never written, may hold anything) is
  // selected away.
  const int octs = d / rows::kVec, groups = kAttnThreads / octs;
  const int c8 = (tid % octs) * rows::kVec, grp = tid / octs;
  float o[rows::kVec];
#pragma unroll
  for (int e = 0; e < rows::kVec; ++e) o[e] = 0.f;
  if (grp < groups) {
    for (int j0 = grp; j0 < s; j0 += kLoads * groups) {
      float vv[kLoads][rows::kVec];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (j0 + u * groups < s) load8c(vb + (size_t)(j0 + u * groups) * d + c8, vv[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = j0 + u * groups;
        if (j < s) {
          const float pj = sc[j];
#pragma unroll
          for (int e = 0; e < rows::kVec; ++e)
            o[e] = fmaf(pj, pj == 0.f ? 0.f : (j == slot ? vn_s[c8 + e] : vv[u][e]), o[e]);
        }
      }
    }
    if constexpr (!kPartOverScores) {
#pragma unroll
      for (int e = 0; e < rows::kVec; ++e) part[grp * d + c8 + e] = o[e];
    }
  }
  if constexpr (kPartOverScores) {
    __syncthreads();  // every score is read
    if (grp < groups) {
#pragma unroll
      for (int e = 0; e < rows::kVec; ++e) part[grp * d + c8 + e] = o[e];
    }
  }
  __syncthreads();
  if (tid < d) {
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * d + tid];
    attn[(size_t)b * inner + (size_t)head * d + tid] = from_f32<T>(l > 0.f ? tot / l : 0.f);  // 0-denominator guard
  }
}

// attend_at for K3's and K6's launches: the scores in the launch's dynamic
// shared memory (S floats), the other arrays static.
template <typename T, typename C, int kBlockThreads = kAttnThreads, bool kCg = false>
__device__ __forceinline__ void attend_body(
    int bh, const NewToken<T>& src, C* k, C* v, float* ks, float* vs, const uint8_t* __restrict__ mask,
    const float* __restrict__ slopes, const int* __restrict__ slot_ptr, T* __restrict__ attn, int h,
    int h_kv, int s, int d, float scale) {
  extern __shared__ float sc[];
  __shared__ float q_s[kMaxD], kn_s[kMaxD], vn_s[kMaxD];
  __shared__ float red[kAttnWarps], part[kAttnThreads * rows::kVec];
  attend_at<T, C, kBlockThreads, kCg, false>(bh, src, k, v, ks, vs, mask, slopes, slot_ptr, attn, h, h_kv, s, d,
                                             scale, AttendSmem{sc, q_s, kn_s, vn_s, red, part});
}

}  // namespace
