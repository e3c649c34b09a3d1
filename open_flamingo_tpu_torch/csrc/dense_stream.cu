// K1 fused_dense and K2 fused_mlp for Hopper (sm_90a): the weight-streaming
// halves of a single-token decode step.
//
//   replaces open_flamingo_tpu/ops/dense_stream.py `fused_dense` (kernel
//   `_dense_kernel`) and `fused_mlp` (kernel `_mlp_kernel`).
//
// K1: out = epilogue(LN?(x) @ W^T), one launch of the row GEMV. On the
// decode path it is the final LayerNorm fused into the tied-embedding vocab
// head: W is the (V, D) embedding table read in place, and each column is
// one of its rows, so the ragged vocabulary (50434 = 197 * 256 + 2) needs no
// masking: the rows past V are zero-filled in the ring and their outputs
// dropped.
//
// K2: out = residual + tanh(gate) * (act(LN?(x) @ W1^T + b1) @ W2^T + b2),
// W1 (K2, K) and W2 (N, K2) in torch's layout. The TPU kernel walks the
// hidden axis as a sequential grid with an fp32 VMEM accumulator. CUDA
// blocks run in no order, so here the hidden axis is split between the two
// products instead: launch 1 writes the (B, K2) hidden activation, rounded
// to x's dtype exactly where the TPU kernel casts it (128 KB at B = 8 bf16,
// which stays in L2), launch 2 reduces over it per output column. Both are
// deterministic (no atomic touches a sum), and a hidden size that is not a
// multiple of any block (e.g. 352) needs no masking.
//
// The row GEMV: in bf16 every launch runs the weight-streaming body of
// rows_stream.cuh (a cp.async ring per warp into mma.sync, all rows up to 64
// in one pass, K cut into slices by the plan that ops/dense_stream.py
// `stream_plan` computes and passes in, with the scratch and counts a split
// K needs); in fp32 the CUDA-core body of rows_gemv.cuh (`gemv_body`, the
// exact path of the card's fp32 gates).
//
// Bound: the weight bytes over 3.35 TB/s; the hidden round trip adds
// 2 * B * K2 * 2 bytes, under 0.5% of K2's bf16 weight bytes at B 8.
//
// Quantized weights (the TPU kernels' int8 / int4 weight streaming): either
// weight may be int8 or packed int4 with its per-out-channel fp32 scale,
// applied first in its epilogue (K1: before bias/clip/act/gate/residual;
// K2: w1_scale before b1 and the activation, w2_scale before b2). The bound
// falls with the bytes: half for int8, a quarter for int4.
//
// Norms and activations (the TPU kernels' `_norm_f32` and `_act_f32`): the
// prologue is a LayerNorm or an RMSNorm (llama: x * rsqrt(E[x^2] + eps) *
// scale, no bias), the activation none, exact GELU, gelu_new, relu,
// quick_gelu or silu, in the fp32 epilogue after bias and clip.
//
// SwiGLU (K2 with `w1_gate`, llama's gate_proj / up_proj):
// u = act(h @ W1^T * s1 + b1) * (h @ W1g^T * s1g), rounded to x's dtype as
// the hidden activation, then W2 as above. It stays two launches: launch 1
// is the gated row GEMV, which streams the same column's row of W1 and of
// W1g against one staged h into two fp32 sums and multiplies them in its
// epilogue, so u keeps its one rounding and no fp32 scratch is written. W1
// and W1g share one stored type. Bound: the three weights' bytes (270.5 MB
// per LLaMA-7B layer in bf16, 0.0807 ms at 3.35 TB/s).
//
// K2b side tiles (`fused_mlp_side_fwd`, the TPU kernel's side_x / side_w):
// an unrelated GEMM tile of the absorbed next-batch ViT rides the
// down-projection launch as extra blocks (side_tile.cuh), in every weight
// type K2 streams. Launch 1 and the down-projection's own output are those
// of fused_mlp_fwd, bit for bit: the body's blocks walk the same plan. With
// side_ws the tile is the W8A8 one (K2b int8, side_tile.cuh): int8 side_w,
// per-row int8 activations.

#include "rows_gemv.cuh"
#include "rows_stream.cuh"
#include "side_tile.cuh"

namespace {

using rows::StreamPlan;
using rows::StreamSplit;

// One row GEMV of K1 or K2 in x's dtype: bf16 on the weight-streaming body
// with its plan, fp32 on the CUDA-core body.
template <typename T>
cudaError_t gemv(int wtype, const T* x, const T* ln_s, const T* ln_b, float eps, int norm, const void* w,
                 const void* wg, rows::Epilogue<T> ep, T* out, int b, int n, int k, StreamPlan plan,
                 StreamSplit split, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return rows::launch_gemv_stream(wtype, x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, plan, split, st);
  else
    return rows::launch_gemv_norm<T, T>(wtype, x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
}

template <typename T>
int dense(const void* x, const void* w, const void* w_scale, const void* bias, const void* ln_s, const void* ln_b,
          const void* residual, const void* gate, void* out, int b, int n, int k, int has_clip, float clip, int act,
          float eps, int norm, int wtype, StreamPlan plan, StreamSplit split, cudaStream_t st) {
  rows::Epilogue<T> ep{(const float*)w_scale, (const T*)bias, has_clip, clip, act, (const T*)gate,
                       (const T*)residual, nullptr};
  return (int)gemv<T>(wtype, (const T*)x, (const T*)ln_s, (const T*)ln_b, eps, norm, w, nullptr, ep, (T*)out, b, n,
                      k, plan, split, st);
}

template <typename T>
int mlp(const void* x, const void* w1, const void* w1g, const void* w2, const void* w1_scale, const void* w1g_scale,
        const void* w2_scale, const void* b1, const void* b2, const void* ln_s, const void* ln_b, const void* residual,
        const void* gate, void* hidden, void* out, int b, int k, int k2, int n, int act, float eps, int norm,
        int w1type, int w2type, StreamPlan up_plan, StreamPlan down_plan, StreamSplit split, cudaStream_t st,
        const side::Args<T>* sa = nullptr) {
  rows::Epilogue<T> up{(const float*)w1_scale, (const T*)b1, 0, 0.f, act, nullptr, nullptr, (const float*)w1g_scale};
  cudaError_t e = gemv<T>(w1type, (const T*)x, (const T*)ln_s, (const T*)ln_b, eps, norm, w1, w1g, up, (T*)hidden, b,
                          k2, k, up_plan, split, st);
  if (e != cudaSuccess) return (int)e;
  rows::Epilogue<T> down{(const float*)w2_scale, (const T*)b2, 0, 0.f, rows::kNone, (const T*)gate,
                         (const T*)residual, nullptr};
  if (sa != nullptr)
    return (int)side::launch_gemv_side<T>(w2type, (const T*)hidden, w2, down, (T*)out, b, n, k2, *sa, st, &down_plan,
                                          split);
  return (int)gemv<T>(w2type, (const T*)hidden, nullptr, nullptr, 0.f, rows::kLayerNorm, w2, nullptr, down, (T*)out,
                      b, n, k2, down_plan, split, st);
}

}  // namespace

// x (B, K); w (N, K) in x's dtype or int8, or (N, K/2) packed int4, as
// wtype says (0, 1, 2); w_scale (N,) fp32 or NULL; bias (N,), ln_s/ln_b
// (K,), residual (B, N), gate (1,) or NULL, all in x's dtype; out (B, N).
// act: rows::Act (0 none, 1 exact GELU, 2 gelu_new, 3 relu, 4 quick_gelu,
// 5 silu); norm: rows::Norm (0 LayerNorm, 1 RMSNorm). dtype 0 = fp32,
// 1 = bf16. bf16 only: slice, blocks, the weight-streaming body's plan
// (ring stages per K slice, blocks); with more than one slice, scratch
// (fp32, the plan's partials) and counters (ncount int32 zeros, one per
// 256-column tile, left zero).
extern "C" int fused_dense_fwd(const void* x, const void* w, const void* w_scale, const void* bias, const void* ln_s,
                               const void* ln_b, const void* residual, const void* gate, void* out, int b, int n,
                               int k, int has_clip, float clip, int act, float eps, int norm, int dtype, int wtype,
                               int slice, int blocks, void* scratch, void* counters, int ncount, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan plan{slice, blocks};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return dense<float>(x, w, w_scale, bias, ln_s, ln_b, residual, gate, out, b, n, k, has_clip, clip, act, eps,
                        norm, wtype, plan, split, st);
  if (dtype == 1)
    return dense<__nv_bfloat16>(x, w, w_scale, bias, ln_s, ln_b, residual, gate, out, b, n, k, has_clip, clip, act,
                                eps, norm, wtype, plan, split, st);
  return (int)cudaErrorInvalidValue;
}

// x (B, K); w1 (K2, K), w1g (K2, K) or NULL (SwiGLU), both stored as w1type
// says; w2 (N, K2) as w2type says; w1_scale / w1g_scale (K2,), w2_scale
// (N,) fp32 or NULL; b1 (K2,), b2 (N,), ln_s/ln_b (K,), residual (B, N),
// gate (1,) or NULL; hidden (B, K2) scratch; out (B, N). act and norm as
// fused_dense_fwd's. bf16 only: (slice1, blocks1), (slice2, blocks2) the
// plans of launch 1 and 2, scratch and counters as fused_dense_fwd's,
// shared by both launches (scratch for the larger of their partials).
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* w1g, const void* w2, const void* w1_scale,
                             const void* w1g_scale, const void* w2_scale, const void* b1, const void* b2,
                             const void* ln_s, const void* ln_b, const void* residual, const void* gate, void* hidden,
                             void* out, int b, int k, int k2, int n, int act, float eps, int norm, int dtype,
                             int w1type, int w2type, int slice1, int blocks1, int slice2, int blocks2, void* scratch,
                             void* counters, int ncount, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan up{slice1, blocks1}, down{slice2, blocks2};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return mlp<float>(x, w1, w1g, w2, w1_scale, w1g_scale, w2_scale, b1, b2, ln_s, ln_b, residual, gate, hidden, out,
                      b, k, k2, n, act, eps, norm, w1type, w2type, up, down, split, st);
  if (dtype == 1)
    return mlp<__nv_bfloat16>(x, w1, w1g, w2, w1_scale, w1g_scale, w2_scale, b1, b2, ln_s, ln_b, residual, gate,
                              hidden, out, b, k, k2, n, act, eps, norm, w1type, w2type, up, down, split, st);
  return (int)cudaErrorInvalidValue;
}

// fused_mlp_fwd with a K2b side tile in its down-projection launch:
// side_out (M, SN) = act(LN?(side_x)) @ side_w^T + side_b + side_res, side_x
// (M, SK) contiguous, side_w (SN, SK) with rows side_ldw elements apart,
// side_ln_s / side_ln_b (SK,), side_b (SN,) or NULL, side_res (M, SN) with
// rows side_ldr apart or NULL, all in x's dtype; side_act a rows::Act. SK a
// multiple of 32. With side_ws (SN,) fp32, side_w is int8 (rows side_ldw
// bytes apart, a multiple of 16) and the tile is the W8A8 one. side_span:
// the columns of each side block of the ring tile (bf16 and W8A8), a
// multiple of 256 (ops/dense_stream.py `side_span`). The other arguments and
// `out` as fused_mlp_fwd's.
extern "C" int fused_mlp_side_fwd(const void* x, const void* w1, const void* w1g, const void* w2, const void* w1_scale,
                                  const void* w1g_scale, const void* w2_scale, const void* b1, const void* b2,
                                  const void* ln_s, const void* ln_b, const void* residual, const void* gate,
                                  void* hidden, void* out, int b, int k, int k2, int n, int act, float eps, int norm,
                                  int dtype, int w1type, int w2type, int slice1, int blocks1, int slice2, int blocks2,
                                  void* scratch, void* counters, int ncount, const void* side_x, const void* side_w,
                                  long long side_ldw, const void* side_ws, const void* side_ln_s,
                                  const void* side_ln_b, float side_eps,
                                  int side_act, const void* side_b, const void* side_res, long long side_ldr,
                                  void* side_out, int m, int sn, int sk, int side_span,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StreamPlan up{slice1, blocks1}, down{slice2, blocks2};
  const StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0) {
    const side::Args<float> sa = side::args<float>(side_x, side_w, side_ldw, side_ws, side_ln_s, side_ln_b, side_eps,
                                                   side_act, side_b, side_res, side_ldr, side_out, m, sn, sk,
                                                   side_span);
    return mlp<float>(x, w1, w1g, w2, w1_scale, w1g_scale, w2_scale, b1, b2, ln_s, ln_b, residual, gate, hidden, out,
                      b, k, k2, n, act, eps, norm, w1type, w2type, up, down, split, st, &sa);
  }
  if (dtype == 1) {
    const side::Args<__nv_bfloat16> sa = side::args<__nv_bfloat16>(side_x, side_w, side_ldw, side_ws, side_ln_s,
                                                                    side_ln_b, side_eps, side_act, side_b, side_res,
                                                                    side_ldr, side_out, m, sn, sk, side_span);
    return mlp<__nv_bfloat16>(x, w1, w1g, w2, w1_scale, w1g_scale, w2_scale, b1, b2, ln_s, ln_b, residual, gate,
                              hidden, out, b, k, k2, n, act, eps, norm, w1type, w2type, up, down, split, st, &sa);
  }
  return (int)cudaErrorInvalidValue;
}
