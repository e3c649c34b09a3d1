// K11 fused_layer_decode for Hopper (sm_90a): a whole decode layer for one
// new token per sequence in ONE launch.
//
//   replaces open_flamingo_tpu/ops/fused_layer.py `fused_layer_decode`
//   (kernel `_layer_kernel`), in both forms the decode path uses:
//   * fused QKV (an MPT block): LN1 -> x @ Wqkv^T (+clip) -> write the new
//     K/V into the cache at `slot`, IN PLACE -> masked softmax with ALiBi
//     -> out-projection -> x2 = x + attn, then LN2(x2) -> up -> act -> down
//     -> y = x2 + mlp;
//   * q only (a gated cross-attention block): LN1 -> x @ Wq^T -> masked
//     softmax over the media K/V -> x2 = x + tanh(gate) * out-projection,
//     then y = x2 + tanh(gate2) * FF(LN2(x2)).
//
// What it computes is K3 (csrc/decode_layer.cu) then K2 (csrc/dense_stream.cu)
// with one difference, the TPU kernel's: x2 stays fp32 (its VMEM scratch),
// LN2 normalises the fp32 value and the last residual adds it; K3 + K2
// round x2 to x's dtype in between. Every other rounding point is K3's and
// K2's (the slot's K/V to the cache dtype, the step attending to the
// unrounded fp32 K/V; the head outputs and the hidden u to x's dtype; each
// int weight's scale first in its epilogue). In fp32 the two routes give
// the same bits.
//
// The TPU kernel phases one sequential grid (head groups, then hidden
// blocks) around four data dependencies. CUDA blocks run in no order, so
// here the launch is persistent and cooperative: as many 512-thread blocks
// as the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, capped by the work), launched with cudaLaunchAttributeCooperative
// so the runtime refuses a grid that cannot be co-resident, and a grid-wide
// barrier (cooperative_groups' grid sync) between the phases:
//   1. proj = clip(LN1(x) @ Wq^T * wq_scale), fp32 (B, 3*H*Dh or H*Dh);
//   2. one (b, h) per block at a time: the attend body of K3
//      (csrc/attend.cuh), 128 of the 512 threads working; head outputs in
//      x's dtype;
//   3. x2 = x + tanh(gate) * (attn @ Wout^T * wout_scale), fp32 (B, D);
//   4. u = act(LN2(x2) @ W1^T * w1_scale + b1) [* LN2(x2) @ W1g^T * w1g_scale],
//      rounded to x's dtype (B, K2);
//   5. y = x2 + tanh(gate2) * (u @ W2^T * w2_scale + b2), in x's dtype.
// Each GEMV phase runs a row GEMV body with the physical grid: phases 1 and
// 3 csrc/rows_gemv.cuh's (the tensor-core body in bf16, its K split from
// `mma_grid`, and the CUDA-core body in fp32, K3's), phases 4 and 5 K2's (in
// bf16 the weight-streaming body of csrc/rows_stream.cuh on the plan the
// wrapper passes, the separate launches' plan, with its scratch and counts
// for a split K; in fp32 the CUDA-core body). A column's sums depend on the
// plan alone, not on the grid, so the products add in K2's order, and in
// fp32 in K3's. (K3's bf16 launches run the weight-streaming body, whose K
// order differs from the tensor-core body's: in bf16 K11's y is K3 + K2's
// within rounding, not bit for bit.) proj, the head outputs,
// x2 and u are written by other blocks of this launch: every read of them
// goes through L2 alone (ld.global.cg, the bodies' kCg instances), never the
// read-only path or L1.
//
// Bound: the weight bytes (Wqkv + Wout + W1 + W2, 100.7 MB per MPT-1B layer
// in bf16; Wq + Wout + the FF, 71.3 MB per gated block) plus the valid
// cache rows, over 3.35 TB/s: 0.031 / 0.021 ms. What it saves is four
// launches of five and the host's second wrapper call per block; what it
// costs is four grid barriers and one block per SM (the largest phase's
// shared memory: in bf16 the weight-streaming body's 193 KB, in fp32 the
// CUDA-core body's staged rows). In bf16 a layer takes up to 64 rows.

#include <cooperative_groups.h>

#include <algorithm>

#include "attend.cuh"
#include "rows_gemv.cuh"
#include "rows_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;

// How one row-GEMV phase runs: the weight-streaming body on its plan
// (stream), the tensor-core body with K split ks ways (mma), or the CUDA-core
// body staging `rows` rows per pass; `blocks`, the blocks it has work for.
struct Phase {
  int stream, mma, ks, rows, blocks;
  rows::StreamPlan sp;
};

// The operands of one layer (x's dtype T unless stated; see the C entry).
// The epilogues are filled on the host and read as kernel parameters, as the
// separate launches read theirs: built in the kernel from constants, their
// null-pointer branches would fold away, and with them the places where K3's
// and K2's code keeps a product and a sum apart (rows_gemv.cuh, the kCg note).
template <typename T>
struct Layer {
  const T *x, *ln1_s, *ln1_b, *ln2_s, *ln2_b;
  const void *wq, *wout, *w1, *w1g, *w2;
  T *k, *v;
  const uint8_t* mask;
  const float* slopes;
  const int* slot;
  float* proj;
  T* attn;
  float* x2;
  T *u, *y;
  int b, dm, h, d, s, p, k2;
  float scale, eps;
  rows::Epilogue<T> ep1, ep3, ep4;  // projection, out-projection, up
  rows::Epilogue<T, float> ep5;     // down, the fp32 x2 as its residual
  Phase ph[4];                      // projection, out-projection, up, down
  rows::StreamSplit split;          // up's and down's split K (bf16)
};

template <typename T, typename W, typename OutT, bool kGated, int kAct, typename X, typename R, bool kK2 = false>
__device__ __forceinline__ void gemv_phase(const Phase& ph, const X* x, const T* ln_s, const T* ln_b, float eps,
                                           const void* w, const void* wg, const rows::Epilogue<T, R>& ep, OutT* out,
                                           int b, int n, int k, const rows::StreamSplit& split, unsigned char* smem) {
  const auto* wb = static_cast<const unsigned char*>(w);
  const auto* gb = static_cast<const unsigned char*>(wg);
  if constexpr (std::is_same<T, bf16>::value && kK2) {  // K2's phases
    rows::stream_body<W, OutT, kGated, kAct, X, R, true>(x, ln_s, ln_b, eps, rows::kLayerNorm, wb, gb, ep, out, b, n,
                                                         k, ph.sp, split, smem, gridDim.x, blockIdx.x);
  } else {
    if constexpr (std::is_same<T, bf16>::value) {
      if (ph.mma) {
        rows::gemv_mma_body<W, OutT, kGated, kAct, X, R, true>(x, ln_s, ln_b, eps, rows::kLayerNorm, wb, gb, ep, out,
                                                               b, n, k, ph.ks, smem, gridDim.x, blockIdx.x);
        return;
      }
    }
    rows::gemv_body<T, W, OutT, kGated, kAct, X, R, true>(x, ln_s, ln_b, eps, rows::kLayerNorm, wb, gb, ep, out, b, n,
                                                          k, ph.rows, smem, gridDim.x, blockIdx.x);
  }
}

template <typename T, typename W, int kAct, bool kGated>
__global__ void __launch_bounds__(rows::kThreads, 1) fused_layer_kernel(const Layer<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // 1. the projection, fp32 and unrounded (K3's launch 1)
  gemv_phase<T, W, float, false, rows::kActBase, T, T>(a.ph[0], a.x, a.ln1_s, a.ln1_b, a.eps, a.wq, nullptr, a.ep1,
                                                       a.proj, a.b, a.p, a.dm, a.split, smem);
  grid.sync();

  // 2. the attend, one (b, h) per block at a time (K3's launch 2)
  const NewToken<T> src{a.proj, a.p, nullptr, nullptr, nullptr};
  for (int bh = blockIdx.x; bh < a.b * a.h; bh += gridDim.x) {
    attend_body<T, T, rows::kThreads, true>(bh, src, a.k, a.v, nullptr, nullptr, a.mask, a.slopes, a.slot, a.attn,
                                            a.h, a.h, a.s, a.d, a.scale);
    __syncthreads();  // the next (b, h) reuses the scores and the statics
  }
  grid.sync();

  // 3. x2 = x + tanh(gate) * out-projection, kept fp32 (the TPU kernel's scratch)
  const T* none = nullptr;  // phases 3 and 5 stage their rows as they are
  gemv_phase<T, W, float, false, rows::kActBase, T, T>(a.ph[1], a.attn, none, none, a.eps, a.wout, nullptr, a.ep3,
                                                       a.x2, a.b, a.dm, a.h * a.d, a.split, smem);
  grid.sync();

  // 4. the hidden activation from LN2 of the fp32 x2, rounded to T (K2's launch 1)
  gemv_phase<T, W, T, kGated, kAct, float, T, true>(a.ph[2], a.x2, a.ln2_s, a.ln2_b, a.eps, a.w1, a.w1g, a.ep4, a.u, a.b,
                                              a.k2, a.dm, a.split, smem);
  grid.sync();

  // 5. y = x2 + tanh(gate2) * down-projection, the fp32 x2 as the residual (K2's launch 2)
  gemv_phase<T, W, T, false, rows::kActBase, T, float, true>(a.ph[3], a.u, none, none, a.eps, a.w2, nullptr, a.ep5, a.y,
                                                       a.b, a.dm, a.k2, a.split, smem);
}

// Plans one GEMV phase of N columns over K within `avail` bytes of dynamic
// shared memory (the tensor cores for bf16 with K a multiple of 32 when 8
// staged rows fit, else the CUDA-core body), and grows `smem` to what it
// needs. False when not one row fits.
template <typename T>
bool plan(Phase& ph, int n, int k, int b, bool gated, size_t avail, size_t& smem) {
  if (std::is_same<T, bf16>::value && k % rows::kMmaK == 0 && rows::mma_smem(k, gated) <= avail) {
    int ks, blocks;
    rows::mma_grid(n, k, &ks, &blocks);
    ph = Phase{0, 1, ks, 0, blocks, {}};
    smem = std::max(smem, rows::mma_smem(k, gated));
    return true;
  }
  const int fit = (int)std::min<size_t>(avail / ((size_t)k * sizeof(T)), rows::kMaxRows);
  const int rows_per_pass = std::min(fit, b);
  if (rows_per_pass < 1) return false;
  ph = Phase{0, 0, 0, rows_per_pass, rows::grid_for(((long long)n + rows::kWarps - 1) / rows::kWarps), {}};
  smem = std::max(smem, (size_t)rows_per_pass * k * sizeof(T));
  return true;
}

// K2's phases: in bf16 the weight-streaming body on the separate launch's
// plan `sp` (at most 64 rows), else `plan`'s CUDA-core body.
template <typename T, typename W>
bool plan_k2(Phase& ph, int n, int k, int b, bool gated, rows::StreamPlan sp, const rows::StreamSplit& split,
             size_t avail, size_t& smem) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (b > rows::kStreamRows || rows::kStreamSmem > avail || !rows::stream_plan_ok<W>(sp, split, n, k)) return false;
    ph = Phase{1, 0, 0, 0, sp.blocks, sp};
    smem = std::max(smem, rows::kStreamSmem);
    return true;
  } else {
    return plan<T>(ph, n, k, b, gated, avail, smem);
  }
}

template <typename T, typename W, int kAct, bool kGated>
cudaError_t launch(Layer<T> a, cudaStream_t st) {
  auto kern = fused_layer_kernel<T, W, kAct, kGated>;
  static size_t static_smem = ~(size_t)0;  // the attend body's shared arrays
  if (static_smem == ~(size_t)0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    static_smem = fa.sharedSizeBytes;
  }
  const size_t avail = (size_t)rows::smem_optin() - static_smem;
  size_t smem = (size_t)a.s * sizeof(float);  // the attend phase's scores
  if (smem > avail || !plan<T>(a.ph[0], a.p, a.dm, a.b, false, avail, smem) ||
      !plan<T>(a.ph[1], a.dm, a.h * a.d, a.b, false, avail, smem) ||
      !plan_k2<T, W>(a.ph[2], a.k2, a.dm, a.b, kGated, a.ph[2].sp, a.split, avail, smem) ||
      !plan_k2<T, W>(a.ph[3], a.dm, a.k2, a.b, false, a.ph[3].sp, a.split, avail, smem))
    return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;
  cudaError_t e = rows::allow_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  static size_t occ_smem = 0;
  static int per_sm = 0;
  if (occ_smem != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, rows::kThreads, smem);
    if (e != cudaSuccess) return e;
    occ_smem = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int work = a.b * a.h;
  for (const Phase& ph : a.ph) work = std::max(work, ph.blocks);
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::min(per_sm * rows::sm_count(), work));
  cfg.blockDim = dim3(rows::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The instances: GELU or none (the decode path's), any activation, and the
// gated form (SwiGLU) with any activation.
template <typename T, typename W>
cudaError_t launch_act(const Layer<T>& a, cudaStream_t st) {
  if (a.w1g != nullptr) return launch<T, W, rows::kActRuntime, true>(a, st);
  if (a.ep4.act <= rows::kGelu) return launch<T, W, rows::kActBase, false>(a, st);
  return launch<T, W, rows::kActRuntime, false>(a, st);
}

template <typename T>
int layer(const void* x, const void* ln1_s, const void* ln1_b, const void* wq, const void* wq_scale, const void* wout,
          const void* wout_scale, void* k, void* v, const void* mask, const void* slopes, const void* gate,
          const void* slot, const void* w1, const void* w1g, const void* w2, const void* w1_scale,
          const void* w1g_scale, const void* w2_scale, const void* b1, const void* b2, const void* ln2_s,
          const void* ln2_b, const void* gate2, void* proj, void* attn, void* x2, void* u, void* y, int b, int dm, int h,
          int d, int s, int k2, int fused_qkv, int has_clip, int wtype, int act, float clip, float scale, float eps,
          rows::StreamPlan up, rows::StreamPlan down, rows::StreamSplit split, cudaStream_t st) {
  Layer<T> a = {};
  a.ph[2].sp = up;
  a.ph[3].sp = down;
  a.split = split;
  a.x = (const T*)x;
  a.ln1_s = (const T*)ln1_s;
  a.ln1_b = (const T*)ln1_b;
  a.ln2_s = (const T*)ln2_s;
  a.ln2_b = (const T*)ln2_b;
  a.wq = wq;
  a.wout = wout;
  a.w1 = w1;
  a.w1g = w1g;
  a.w2 = w2;
  a.k = (T*)k;
  a.v = (T*)v;
  a.mask = (const uint8_t*)mask;
  a.slopes = (const float*)slopes;
  a.slot = fused_qkv ? (const int*)slot : nullptr;
  a.proj = (float*)proj;
  a.attn = (T*)attn;
  a.x2 = (float*)x2;
  a.u = (T*)u;
  a.y = (T*)y;
  a.b = b;
  a.dm = dm;
  a.h = h;
  a.d = d;
  a.s = s;
  a.p = (fused_qkv ? 3 : 1) * h * d;
  a.k2 = k2;
  a.scale = scale;
  a.eps = eps;
  // K3's and K2's epilogues, field for field
  a.ep1 = rows::Epilogue<T>{(const float*)wq_scale, nullptr, has_clip, clip, rows::kNone, nullptr, nullptr, nullptr};
  a.ep3 = rows::Epilogue<T>{(const float*)wout_scale, nullptr, 0, 0.f, rows::kNone, (const T*)gate, (const T*)x,
                            nullptr};
  a.ep4 = rows::Epilogue<T>{(const float*)w1_scale, (const T*)b1, 0, 0.f, act, nullptr, nullptr,
                            (const float*)w1g_scale};
  a.ep5 = rows::Epilogue<T, float>{(const float*)w2_scale, (const T*)b2, 0, 0.f, rows::kNone, (const T*)gate2,
                                   (const float*)x2, nullptr};
  switch (wtype) {
    case 0: return (int)launch_act<T, T>(a, st);
    case 1: return (int)launch_act<T, int8_t>(a, st);
    case 2: return (int)launch_act<T, rows::Int4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, D); ln1_s/ln1_b, ln2_s/ln2_b (D,), the biases or NULL; wq (3*H*Dh
// or H*Dh, D), wout (D, H*Dh), w1 (K2, D), w1g (K2, D) or NULL (SwiGLU), w2
// (D, K2), all in x's dtype, int8 or packed int4 as wtype says (0, 1, 2:
// one stored type for every weight), with wq_scale / wout_scale / w1_scale
// / w1g_scale / w2_scale (rows,) fp32 for an int weight, else NULL; k/v
// (B, H, S <= 8192, Dh <= 128, a multiple of 8) in x's dtype; mask (B, S)
// uint8; slopes (H,) fp32 or NULL; gate / gate2 (1,) or NULL; slot (1,)
// int32 on the device (fused_qkv); b1 (K2,), b2 (D,) or NULL; scratch proj
// (B, 3*H*Dh or H*Dh) fp32, attn (B, H*Dh), x2 (B, D) fp32, u (B, K2); out
// y (B, D). act: rows::Act. dtype 0 = fp32, 1 = bf16. D, H*Dh and K2
// multiples of 8. bf16 only: (slice4, blocks4), (slice5, blocks5) the
// plans of K2's launches for phases 4 and 5 (ops/dense_stream.py
// `stream_plan`), scratch and counters as fused_mlp_fwd's; B <= 64. Returns
// the launch's CUDA error code (a refused cooperative launch included).
extern "C" int fused_layer_decode_fwd(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wq, const void* wq_scale, const void* wout,
    const void* wout_scale, void* k, void* v, const void* mask, const void* slopes, const void* gate,
    const void* slot, const void* w1, const void* w1g, const void* w2, const void* w1_scale, const void* w1g_scale,
    const void* w2_scale, const void* b1, const void* b2, const void* ln2_s, const void* ln2_b, const void* gate2,
    void* proj, void* attn, void* x2, void* u, void* y, int b, int dm, int h, int d, int s, int k2, int fused_qkv,
    int has_clip, int wtype, int act, float clip, float scale, float eps, int slice4, int blocks4, int slice5,
    int blocks5, void* scratch, void* counters, int ncount, int dtype, void* stream) {
  if (d < rows::kVec || d > kMaxD || d % rows::kVec != 0 || b < 1 || h < 1 || s < 1 || s > kMaxS ||
      dm < rows::kVec || dm % rows::kVec != 0 || k2 < rows::kVec || k2 % rows::kVec != 0)
    return (int)cudaErrorInvalidValue;
  if ((fused_qkv && slot == nullptr) || act < rows::kNone || act > rows::kSilu ||
      (w1g_scale != nullptr && w1g == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const rows::StreamPlan up{slice4, blocks4}, down{slice5, blocks5};
  const rows::StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return layer<float>(x, ln1_s, ln1_b, wq, wq_scale, wout, wout_scale, k, v, mask, slopes, gate, slot, w1, w1g, w2,
                        w1_scale, w1g_scale, w2_scale, b1, b2, ln2_s, ln2_b, gate2, proj, attn, x2, u, y, b, dm, h, d,
                        s, k2, fused_qkv, has_clip, wtype, act, clip, scale, eps, up, down, split, st);
  if (dtype == 1)
    return layer<bf16>(x, ln1_s, ln1_b, wq, wq_scale, wout, wout_scale, k, v, mask, slopes, gate, slot, w1, w1g, w2,
                       w1_scale, w1g_scale, w2_scale, b1, b2, ln2_s, ln2_b, gate2, proj, attn, x2, u, y, b, dm, h, d, s,
                       k2, fused_qkv, has_clip, wtype, act, clip, scale, eps, up, down, split, st);
  return (int)cudaErrorInvalidValue;
}
