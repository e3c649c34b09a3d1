// K3 attn_block_decode for Hopper (sm_90a): the whole attention half of a
// decode layer for one new token per sequence.
//
//   replaces open_flamingo_tpu/ops/decode_layer.py `attn_block_decode`
//   (kernel `_attn_block_kernel`), in both forms the decode path uses:
//   * fused QKV (MPT self-attention): LN -> x @ Wqkv^T (+clip) -> write the
//     new K/V into the cache at `slot`, IN PLACE -> masked softmax with
//     ALiBi over the cache -> out-projection -> + x;
//   * q only (gated cross-attention): LN -> x @ Wq^T -> masked softmax over
//     the media K/V cached at prefill -> out-projection -> * tanh(gate) + x.
//
// The TPU kernel walks head groups as a sequential grid and accumulates
// the out-projection in VMEM. CUDA blocks run in no order and the
// out-projection sums over every head, so the body runs as three launches
// on one stream, each with the whole card:
//   1. proj = clip(LN(x) @ Wq^T) in fp32 (B, 3*H*Dh or H*Dh) -- the row
//      GEMV (below); q/k/v stay UNROUNDED, as in the TPU kernel;
//   2. one block per (b, h): writes the new K/V row at `slot` rounded to the
//      cache dtype, attends with the unrounded fp32 K/V at that slot (the
//      TPU kernel's `jnp.where(at_slot, kn, k)`), writes the head's output
//      rounded to x's dtype (the TPU kernel's cast before the out-proj);
//   3. out = x + tanh(gate) * (attn @ Wout^T) -- the row GEMV again.
// `slot` is a device int32, the counterpart of the TPU kernel's
// scalar-prefetch operand: the host never reads it, so the call can be
// captured in a CUDA graph as it is.
//
// Masking: a (B, S) validity mask (pad, causality and the media-time rule
// folded in by the caller), ALiBi slope_h * (j - (S_max - 1)). A row with no
// valid key gives exact zeros (0-denominator guard), as the TPU kernel's.
//
// Bound: the weight bytes (Wqkv + Wout, 33.6 MB at MPT-1B bf16) plus the
// valid cache rows, over 3.35 TB/s. Launches 1 and 3 stream the weights:
// in bf16 on the weight-streaming row GEMV of rows_stream.cuh (a cp.async
// ring per warp into mma.sync, every row of B <= 64 in one pass of W, K cut
// into slices by the plan ops/dense_stream.py `stream_plan` computes from
// the shape and the SM count and the wrapper passes in, so a column's sums
// add in one order for any B), in fp32 on rows_gemv.cuh's CUDA-core body
// (the exact path of the card's fp32 gates); launch 2 is key-parallel (see
// attend_body, csrc/attend.cuh, which K11's attention phase shares), so its
// latency is two rounds of loads, not a chain per key.
//
// K3 as a carrier of K2b side tiles (K2b-attn; the TPU kernel's side_x /
// side_w, `side_tile_compute` on each head group's grid step): a tile of the
// absorbed next-batch ViT rides launch 3, the out-projection, as extra
// blocks after the row GEMV's (side_tile.cuh's `launch_gemv_side`, the form
// that carries K2's down-projection: in bf16 the weight-streaming body on
// launch 3's plan and split), in x's dtype or the W8A8 tile. Launch 3 is the
// row GEMV without norm or activation whose epilogue is K2's
// down-projection's (scale, gate, residual), so its blocks run the body of
// the launch without a tile on the same plan: y, and the caches written by
// launch 2, are bit for bit those of the call without a tile. It is the simplest host: launch 1
// (Wqkv, 25.2 MB at MPT-1B bf16 against Wout's 8.4 MB) streams more bytes
// for the tile to hide under, but its output is fp32 and its grid is the
// projection's; a later PR can move the tile there if the out-projection
// proves too short to hide it.
//
// K6 attend_out_decode, the same tail for families whose q/k/v come from
// elsewhere (GPT-NeoX: K1, then RoPE), is launches 2 and 3:
//
//   replaces open_flamingo_tpu/ops/decode_layer.py `attend_out_decode`
//   (kernel `_attend_out_kernel`): write the new K/V at `slot` IN PLACE ->
//   masked softmax (GQA, optional ALiBi) -> per-head out-projection summed
//   over heads -> + bias -> * tanh(gate) -> + residual.
//
// The TPU kernel's head grid carries the out-projection sum in VMEM across
// heads; here the head outputs go through a (B, H*Dh) scratch and one row
// GEMV (K3's launch 3 in form, on its own plan) sums over all heads in fp32,
// its epilogue in the TPU kernel's order.
// Bound: Wout (13.1 MB at RedPajama-3B bf16) plus the valid cache rows.
//
// Quantized decode, both kernels (the TPU kernels' int8 / int4 weights and
// int8 KV cache). The projections stream int8 or packed int4 weights
// through the row GEMV (converted exactly before the product), each
// per-out-channel scale first in its epilogue: K3's q/k/v before clip_qkv,
// the out-projections before the gate, bias and residual. The int8 cache holds int8 K/V rows with one fp32
// scale per (b, h, s) row: the block that owns (b, h) quantizes the new
// token's K and V over Dh itself (amax by a block reduction, scale
// amax / 127 or 1, round half to even of a true division), writes the int8
// row and its scale in place, and attends to the quantized value, as later
// steps read it back. Logits dequantize after the dot product (* k_s[j]),
// softmax weights before the sum over values (* v_s[j]). The cache bytes
// halve; the bound falls with the weight bytes (half for int8, a quarter
// for int4) and the cache's.

#include "attend.cuh"
#include "rows_gemv.cuh"
#include "rows_stream.cuh"
#include "side_tile.cuh"

namespace {

using rows::StreamPlan;
using rows::StreamSplit;

// K3's softmax launch: proj (B, p) fp32, H_kv = H.
template <typename T, typename C>
__global__ void __launch_bounds__(kAttnThreads) attend_kernel(
    const float* __restrict__ proj, int p, C* k, C* v, float* ks, float* vs, const uint8_t* __restrict__ mask,
    const float* __restrict__ slopes, const int* __restrict__ slot_ptr, T* __restrict__ attn, int h, int s, int d,
    float scale) {
  attend_body<T, C>(blockIdx.x, NewToken<T>{proj, p, nullptr, nullptr, nullptr}, k, v, ks, vs, mask, slopes,
                    slot_ptr, attn, h, h, s, d, scale);
}

// K6's attend launch: q, k_new, v_new in T; its own symbol, so a profile
// tells it from K3's.
template <typename T, typename C>
__global__ void __launch_bounds__(kAttnThreads) attend_out_kernel(
    const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn, C* k, C* v, float* ks, float* vs,
    const uint8_t* __restrict__ mask, const float* __restrict__ slopes, const int* __restrict__ slot_ptr,
    T* __restrict__ attn, int h, int h_kv, int s, int d, float scale) {
  attend_body<T, C>(blockIdx.x, NewToken<T>{nullptr, 0, q, kn, vn}, k, v, ks, vs, mask, slopes, slot_ptr, attn, h,
                    h_kv, s, d, scale);
}

// One projection of K3 or K6 (no gated weight, no activation), W stored as
// wtype says: bf16 rows on the weight-streaming body with its plan, fp32 on
// the CUDA-core body.
template <typename T, typename OutT>
cudaError_t project(int wtype, const T* x, const T* ln_s, const T* ln_b, float eps, const void* w,
                    rows::Epilogue<T> ep, OutT* out, int b, int n, int k, StreamPlan plan, StreamSplit split,
                    cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return rows::launch_stream_projection<OutT>(wtype, x, ln_s, ln_b, eps, w, ep, out, b, n, k, plan, split, st);
  else
    return rows::launch_gemv_norm<T, OutT>(wtype, x, ln_s, ln_b, eps, rows::kLayerNorm, w, nullptr, ep, out, b, n,
                                           k, st);
}

template <typename T>
int block(const void* x, const void* ln_s, const void* ln_b, const void* wq, const void* wq_scale, const void* wout,
          const void* wout_scale, void* k, void* v, void* k_s, void* v_s, const void* mask, const void* slopes,
          const void* gate, const void* slot, void* proj, void* attn, void* out, int b, int dm, int h, int d, int s,
          int fused_qkv, int has_clip, int wq_type, int wout_type, float clip, float scale, float eps,
          StreamPlan plan1, StreamPlan plan3, StreamSplit split, cudaStream_t st, const side::Args<T>* sa = nullptr) {
  const int inner = h * d;
  const int p = fused_qkv ? 3 * inner : inner;
  rows::Epilogue<T> ep1{(const float*)wq_scale, nullptr, has_clip, clip, 0, nullptr, nullptr};
  cudaError_t e = project<T, float>(wq_type, (const T*)x, (const T*)ln_s, (const T*)ln_b, eps, wq, ep1, (float*)proj,
                                    b, p, dm, plan1, split, st);
  if (e != cudaSuccess) return (int)e;
  const int* sl = fused_qkv ? (const int*)slot : nullptr;
  if (k_s != nullptr)
    attend_kernel<T, int8_t><<<b * h, kAttnThreads, s * sizeof(float), st>>>(
        (const float*)proj, p, (int8_t*)k, (int8_t*)v, (float*)k_s, (float*)v_s, (const uint8_t*)mask,
        (const float*)slopes, sl, (T*)attn, h, s, d, scale);
  else
    attend_kernel<T, T><<<b * h, kAttnThreads, s * sizeof(float), st>>>(
        (const float*)proj, p, (T*)k, (T*)v, nullptr, nullptr, (const uint8_t*)mask, (const float*)slopes, sl,
        (T*)attn, h, s, d, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rows::Epilogue<T> ep3{(const float*)wout_scale, nullptr, 0, 0.f, 0, (const T*)gate, (const T*)x};
  if (sa != nullptr)
    return (int)side::launch_gemv_side<T>(wout_type, (const T*)attn, wout, ep3, (T*)out, b, dm, inner, *sa, st,
                                          &plan3, split);
  return (int)project<T, T>(wout_type, (const T*)attn, nullptr, nullptr, 0.f, wout, ep3, (T*)out, b, dm, inner, plan3,
                            split, st);
}

// K6: attend, then out = residual + tanh(gate) * (attn @ Wout^T * wout_scale + bias).
template <typename T>
int attend_out(const void* q, void* k, void* v, void* k_s, void* v_s, const void* kn, const void* vn,
               const void* slot, const void* mask, const void* slopes, const void* wout, const void* wout_scale,
               const void* bias, const void* gate, const void* residual, void* attn, void* out, int b, int h,
               int h_kv, int s, int d, int dm, int wout_type, float scale, StreamPlan plan, StreamSplit split,
               cudaStream_t st) {
  if (k_s != nullptr)
    attend_out_kernel<T, int8_t><<<b * h, kAttnThreads, s * sizeof(float), st>>>(
        (const T*)q, (const T*)kn, (const T*)vn, (int8_t*)k, (int8_t*)v, (float*)k_s, (float*)v_s,
        (const uint8_t*)mask, (const float*)slopes, (const int*)slot, (T*)attn, h, h_kv, s, d, scale);
  else
    attend_out_kernel<T, T><<<b * h, kAttnThreads, s * sizeof(float), st>>>(
        (const T*)q, (const T*)kn, (const T*)vn, (T*)k, (T*)v, nullptr, nullptr, (const uint8_t*)mask,
        (const float*)slopes, (const int*)slot, (T*)attn, h, h_kv, s, d, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rows::Epilogue<T> ep{(const float*)wout_scale, (const T*)bias, 0, 0.f, 0, (const T*)gate, (const T*)residual};
  return (int)project<T, T>(wout_type, (const T*)attn, nullptr, nullptr, 0.f, wout, ep, (T*)out, b, dm, h * d, plan,
                            split, st);
}

}  // namespace

// x (B, D); ln_s/ln_b (D,); wq (3*H*Dh or H*Dh, D) and wout (D, H*Dh), each
// in x's dtype, int8 or packed int4 as wq_type/wout_type say (0, 1, 2),
// with wq_scale/wout_scale (rows,) fp32 or NULL; k/v (B, H, S <= 8192,
// Dh <= 128, a multiple of 8) in x's dtype, or int8 with k_s/v_s (B, H, S)
// fp32 (else NULL); mask (B, S) uint8; slopes (H,) fp32 or NULL; gate (1,)
// or NULL; slot (1,) int32 on the device (fused_qkv only); scratch proj
// (B, 3*H*Dh or H*Dh) fp32 and attn (B, H*Dh); out (B, D). Tensors in x's
// dtype unless stated; dtype 0 = fp32, 1 = bf16. bf16 only: (slice1,
// blocks1), (slice3, blocks3) the weight-streaming plans of launches 1 and
// 3 (ops/dense_stream.py `stream_plan`), scratch and counters as
// fused_mlp_fwd's (dense_stream.cu), shared by both launches.
extern "C" int attn_block_decode_fwd(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                                     const void* wq_scale, const void* wout, const void* wout_scale, void* k,
                                     void* v, void* k_s, void* v_s, const void* mask, const void* slopes,
                                     const void* gate, const void* slot, void* proj, void* attn, void* out, int b,
                                     int dm, int h, int d, int s, int fused_qkv, int has_clip, int wq_type,
                                     int wout_type, float clip, float scale, float eps, int dtype, int slice1,
                                     int blocks1, int slice3, int blocks3, void* scratch, void* counters, int ncount,
                                     void* stream) {
  if (d < 1 || d > kMaxD || d % rows::kVec != 0 || b < 1 || h < 1 || s < 1 || s > kMaxS)
    return (int)cudaErrorInvalidValue;
  if ((fused_qkv && slot == nullptr) || (k_s == nullptr) != (v_s == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan plan1{slice1, blocks1}, plan3{slice3, blocks3};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return block<float>(x, ln_s, ln_b, wq, wq_scale, wout, wout_scale, k, v, k_s, v_s, mask, slopes, gate, slot,
                        proj, attn, out, b, dm, h, d, s, fused_qkv, has_clip, wq_type, wout_type, clip, scale, eps,
                        plan1, plan3, split, st);
  if (dtype == 1)
    return block<__nv_bfloat16>(x, ln_s, ln_b, wq, wq_scale, wout, wout_scale, k, v, k_s, v_s, mask, slopes, gate,
                                slot, proj, attn, out, b, dm, h, d, s, fused_qkv, has_clip, wq_type, wout_type, clip,
                                scale, eps, plan1, plan3, split, st);
  return (int)cudaErrorInvalidValue;
}

// attn_block_decode_fwd with a side tile in its out-projection launch:
// side_out (M, SN) = act(LN?(side_x)) @ side_w^T + side_b + side_res, the
// side arguments as fused_mlp_side_fwd's (dense_stream.cu): side_w in x's
// dtype, or int8 with side_ws (SN,) fp32 (the W8A8 tile).
extern "C" int attn_block_decode_side_fwd(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                                          const void* wq_scale, const void* wout, const void* wout_scale, void* k,
                                          void* v, void* k_s, void* v_s, const void* mask, const void* slopes,
                                          const void* gate, const void* slot, void* proj, void* attn, void* out,
                                          int b, int dm, int h, int d, int s, int fused_qkv, int has_clip,
                                          int wq_type, int wout_type, float clip, float scale, float eps, int dtype,
                                          int slice1, int blocks1, int slice3, int blocks3, void* scratch,
                                          void* counters, int ncount, const void* side_x, const void* side_w,
                                          long long side_ldw, const void* side_ws, const void* side_ln_s,
                                          const void* side_ln_b, float side_eps, int side_act, const void* side_b,
                                          const void* side_res, long long side_ldr, void* side_out, int m, int sn,
                                          int sk, int side_span, void* stream) {
  if (d < 1 || d > kMaxD || d % rows::kVec != 0 || b < 1 || h < 1 || s < 1 || s > kMaxS)
    return (int)cudaErrorInvalidValue;
  if ((fused_qkv && slot == nullptr) || (k_s == nullptr) != (v_s == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan plan1{slice1, blocks1}, plan3{slice3, blocks3};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0) {
    const side::Args<float> sa = side::args<float>(side_x, side_w, side_ldw, side_ws, side_ln_s, side_ln_b, side_eps,
                                                   side_act, side_b, side_res, side_ldr, side_out, m, sn, sk,
                                                   side_span);
    return block<float>(x, ln_s, ln_b, wq, wq_scale, wout, wout_scale, k, v, k_s, v_s, mask, slopes, gate, slot,
                        proj, attn, out, b, dm, h, d, s, fused_qkv, has_clip, wq_type, wout_type, clip, scale, eps,
                        plan1, plan3, split, st, &sa);
  }
  if (dtype == 1) {
    const side::Args<__nv_bfloat16> sa = side::args<__nv_bfloat16>(side_x, side_w, side_ldw, side_ws, side_ln_s,
                                                                    side_ln_b, side_eps, side_act, side_b, side_res,
                                                                    side_ldr, side_out, m, sn, sk, side_span);
    return block<__nv_bfloat16>(x, ln_s, ln_b, wq, wq_scale, wout, wout_scale, k, v, k_s, v_s, mask, slopes, gate,
                                slot, proj, attn, out, b, dm, h, d, s, fused_qkv, has_clip, wq_type, wout_type, clip,
                                scale, eps, plan1, plan3, split, st, &sa);
  }
  return (int)cudaErrorInvalidValue;
}

// K6 attend_out_decode. q (B, H, Dh); k/v caches (B, H_kv, S <= 8192,
// Dh <= 128, a multiple of 8) in q's dtype, or int8 with k_s/v_s
// (B, H_kv, S) fp32 (else NULL), H_kv dividing H; kn/vn (B, H_kv, Dh) and
// slot (1,) int32 on the device, or all three NULL (no write); mask (B, S)
// uint8; slopes (H,) fp32 or NULL; wout (D, H*Dh) in q's dtype, int8 or
// packed int4 as wout_type says, wout_scale (D,) fp32 or NULL; bias (D,),
// gate (1,), residual (B, D), each or NULL; scratch attn (B, H*Dh); out
// (B, D). Tensors in q's dtype unless stated; dtype 0 = fp32, 1 = bf16.
// bf16 only: (slice, blocks) the out-projection's weight-streaming plan,
// scratch and counters as attn_block_decode_fwd's.
extern "C" int attend_out_decode_fwd(const void* q, void* k, void* v, void* k_s, void* v_s, const void* kn,
                                     const void* vn, const void* slot, const void* mask, const void* slopes,
                                     const void* wout, const void* wout_scale, const void* bias, const void* gate,
                                     const void* residual, void* attn, void* out, int b, int h, int h_kv, int s, int d,
                                     int dm, int wout_type, float scale, int dtype, int slice, int blocks,
                                     void* scratch, void* counters, int ncount, void* stream) {
  if (d < 1 || d > kMaxD || d % rows::kVec != 0 || b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || s < 1 ||
      s > kMaxS || dm < 1)
    return (int)cudaErrorInvalidValue;
  if ((kn == nullptr) != (vn == nullptr) || (kn == nullptr) != (slot == nullptr) || (k_s == nullptr) != (v_s == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan plan{slice, blocks};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return attend_out<float>(q, k, v, k_s, v_s, kn, vn, slot, mask, slopes, wout, wout_scale, bias, gate, residual,
                             attn, out, b, h, h_kv, s, d, dm, wout_type, scale, plan, split, st);
  if (dtype == 1)
    return attend_out<__nv_bfloat16>(q, k, v, k_s, v_s, kn, vn, slot, mask, slopes, wout, wout_scale, bias, gate,
                                     residual, attn, out, b, h, h_kv, s, d, dm, wout_type, scale, plan, split, st);
  return (int)cudaErrorInvalidValue;
}
