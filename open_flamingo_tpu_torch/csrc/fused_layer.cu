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
// int weight's scale first in its epilogue).
//
// The TPU kernel phases one sequential grid (head groups, then hidden
// blocks) around four data dependencies. CUDA blocks run in no order, so
// here the launch is persistent and cooperative: one 512-thread block per SM
// (capped by the work), launched with cudaLaunchAttributeCooperative so the
// runtime refuses a grid that cannot be co-resident, and a grid-wide barrier
// (cooperative_groups' grid sync) between the phases:
//   1. proj = clip(LN1(x) @ Wq^T * wq_scale), fp32 (B, 3*H*Dh or H*Dh);
//   2. one (b, h) per block at a time: the attend of K3 (csrc/attend.cuh),
//      128 of the 512 threads working; head outputs in x's dtype;
//   3. x2 = x + tanh(gate) * (attn @ Wout^T * wout_scale), fp32 (B, D);
//   4. u = act(LN2(x2) @ W1^T * w1_scale + b1) [* LN2(x2) @ W1g^T * w1g_scale],
//      rounded to x's dtype (B, K2);
//   5. y = x2 + tanh(gate2) * (u @ W2^T * w2_scale + b2), in x's dtype.
// proj, the head outputs, x2, u and a split's partials are written by other
// blocks of this launch: every read of them goes through L2 alone
// (ld.global.cg, the bodies' kCg instances), never the read-only path or L1.
//
// bf16: every row-GEMV phase runs rows_stream.cuh's weight-streaming body on
// the plan of the separate launch that computes it (ops/dense_stream.py
// `stream_plan`, passed in): phases 1 and 3 on K3's, 4 and 5 on K2's. A
// column's sums depend on the plan alone, so the written K/V rows are K3's
// bits, x2 rounded to bf16 is K3's output bit for bit, and phases 4 and 5 add
// in K2's order. The instance follows B as the separate launches' does: one
// n-tile (6 ring stages, 3 gated) for B <= 8, eight (4 stages) past 8 rows.
// The weights do not wait for the barriers: a block issues the first ring
// stages of its first item of the next phase's W (and Wg) as soon as it is
// done with the phase before, then arrives at the barrier; the out-
// projection's stages fly across the attend and both of its barriers. Only
// the h rows, the LayerNorm statistics and the epilogues' inputs wait. Each
// row-GEMV phase and the attend are functions of their own (stream_phase,
// attend_phase), so that each holds the registers its separate launch
// holds, and no state lives across a barrier: a phase's ring is made again
// after it (StreamRing::resume). Any
// B: each phase walks its rows in passes of 64 over the same items, W
// streamed once a pass; past 8 rows a split K writes its partials per pass
// and, after a barrier, the whole grid adds them in slice order (as
// gemv_stream_reduce_kernel does for the separate launches: their bits).
//
// Shared memory, bf16 (the instance's Geometry, one size for the launch):
//   [0, ring)          the ring: phase p's W (and Wg) stages, a warp's own
//                      region the same bytes in either form; from the end of
//                      a block's phase p, phase p + 1's first stages;
//   [ring, +h)         phase p's h slices; in phase 2 the attend's scores
//                      (S floats, at most 32 KB), and after every score is
//                      read its output partials over them (4 KB);
//   [.., kSmem)        the statistics (mean, 1/std of 64 rows) and a split's
//                      last-arrival flag;
//   [kSmem, +1,552)    the attend's q, new K, new V and reduction partials.
// fp32 keeps the CUDA-core body of rows_gemv.cuh in every phase (K3's and
// K2's, staging its rows), the attend's scores and partials over the staged
// rows, its other arrays after them: y and both caches bit for bit those of
// K3 then K2.
//
// Bound: the weight bytes (Wqkv + Wout + W1 + W2, 100.7 MB per MPT-1B layer
// in bf16; Wq + Wout + the FF, 71.3 MB per gated block) plus the valid
// cache rows, over 3.35 TB/s: 0.031 / 0.021 ms. What it saves is four
// launches of five and the host's second wrapper call per block; what it
// costs is four grid barriers (more past 8 rows with a split K) and one
// block per SM.

#include <cooperative_groups.h>

#include <algorithm>

#include "attend.cuh"
#include "rows_gemv.cuh"
#include "rows_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rows::StreamRing;

// bf16: a phase's first ring stages issued before the grid barrier its rows
// wait for (false: after it, chip_profile.py k11's `no_prefetch` variant)
constexpr bool kPrefetch = true;

static_assert(kMaxS * sizeof(float) <= rows::Geometry<1, false>::kHBytes &&
                  kAttnThreads * rows::kVec * sizeof(float) <= rows::Geometry<1, false>::kHBytes &&
                  rows::Geometry<1, false>::kHBytes <= rows::Geometry<8, false>::kHBytes,
              "the attend's scores, and its partials over them, fit the h-slice region of either instance");

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
  rows::StreamPlan plan[4];         // bf16: the separate launches' plans (projection, out-projection, up, down)
  rows::StreamSplit split;          // bf16: their split K's scratch and counts (deferred past 8 rows)
  int pass_rows[4];                 // fp32: the CUDA-core body's rows per pass of each phase
  size_t stats;                     // the attend's q, new K/V and reduction partials, bytes into shared memory
};

// Phase 2, one (b, h) per block at a time (K3's launch 2): the scores
// `scores` bytes into shared memory, its output partials over them once
// read, its other arrays at a.stats; 4 loads in flight a thread, within the
// registers of the block's 512 threads. A function of its own, as each bf16
// row-GEMV phase is (stream_phase).
template <typename T>
__device__ __noinline__ void attend_phase(const Layer<T>& a, size_t scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + scores);
  float* st = reinterpret_cast<float*>(smem + a.stats);
  const AttendSmem m{sc, st, st + kMaxD, st + 2 * kMaxD, st + 3 * kMaxD, sc};
  const NewToken<T> src{a.proj, a.p, nullptr, nullptr, nullptr};
  for (int bh = blockIdx.x; bh < a.b * a.h; bh += gridDim.x) {
    attend_at<T, T, rows::kThreads, true, true, 4>(bh, src, a.k, a.v, nullptr, nullptr, a.mask, a.slopes, a.slot,
                                                   a.attn, a.h, a.h, a.s, a.d, a.scale, m);
    __syncthreads();  // the next (b, h) reuses the scores and the statics
  }
}

// One bf16 row-GEMV phase's ring as this block walks it: W (and Wg) of
// N x K on `plan`, b rows in passes of 64
template <typename W, bool kGated, int kMaxNt>
__device__ __forceinline__ StreamRing<W, kGated, kMaxNt, true> ring(const void* w, const void* wg, int n, int k,
                                                                    const rows::StreamPlan& plan, int b,
                                                                    unsigned char* smem) {
  return StreamRing<W, kGated, kMaxNt, true>(static_cast<const unsigned char*>(w),
                                             static_cast<const unsigned char*>(wg), n, k, b, plan, smem, gridDim.x,
                                             blockIdx.x);
}

// A phase's first stages, issued before the grid barrier its rows wait for
// (kPrefetch); its ring is made again after the barrier (`resume`), so no
// state lives across the barriers and the attend
template <typename W, bool kGated, int kMaxNt>
__device__ __forceinline__ void issue(const void* w, const void* wg, int n, int k, const rows::StreamPlan& plan,
                                      int b, unsigned char* smem) {
  if (kPrefetch) ring<W, kGated, kMaxNt>(w, wg, n, k, plan, b, smem).prologue();
}

// The ring of a phase whose first stages `issue` sent, after the barrier
template <typename W, bool kGated, int kMaxNt>
__device__ __forceinline__ StreamRing<W, kGated, kMaxNt, true> resumed(const void* w, const void* wg, int n, int k,
                                                                       const rows::StreamPlan& plan, int b,
                                                                       unsigned char* smem) {
  StreamRing<W, kGated, kMaxNt, true> r = ring<W, kGated, kMaxNt>(w, wg, n, k, plan, b, smem);
  if (kPrefetch) r.resume();
  else r.prologue();
  return r;
}

// Past 8 rows (kMaxNt 8) a split K's partials are added by the whole grid
// after a barrier; whether phase (N x K on `plan`) has such a split
template <typename W, int kMaxNt>
__device__ __forceinline__ bool deferred(const rows::StreamPlan& plan, int k) {
  return kMaxNt != 1 && rows::stream_slices<W>(plan, k) > 1;
}

// bf16, one row-GEMV phase (kPhase 1, 3, 4 or 5) on the weight-streaming
// body: its consumer, after its ring's first stages (phase 1 issues its own,
// the others' were issued before the barrier), then the next phase's first
// stages. A function of its own: ptxas allocates each phase's registers
// alone, as the separate launch's kernel's. Inlined into one function with
// the others, the phases spilled 1.3-5 KB a thread to local memory (for which
// the 231 KB of shared memory leave almost no L1) and the layer took 5-20%
// longer (on the H100: chip_profile.py k11, its `inline` variant). Nothing
// lives across the calls: each reads the layer from the kernel's parameters
// and its shared memory from its own declaration.
template <int kPhase, typename W, int kAct, bool kGated, int kMaxNt>
__device__ __noinline__ void stream_phase(const Layer<bf16>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kB = rows::kActBase;
  const bf16* none = nullptr;  // phases 3 and 5 stage their rows as they are
  const int inner = a.h * a.d, nb = gridDim.x, blk = blockIdx.x;
  if constexpr (kPhase == 1) {  // the projection, fp32 and unrounded (K3's launch 1)
    auto r = ring<W, false, kMaxNt>(a.wq, nullptr, a.p, a.dm, a.plan[0], a.b, smem);
    r.prologue();
    rows::stream_consume<W, float, false, kB, bf16, bf16, true, kMaxNt, true>(
        r, a.x, a.ln1_s, a.ln1_b, a.eps, rows::kLayerNorm, a.ep1, a.proj, a.b, a.p, a.dm, a.plan[0], a.split, smem,
        nb, blk);
    issue<W, false, kMaxNt>(a.wout, nullptr, a.dm, inner, a.plan[1], a.b, smem);
  } else if constexpr (kPhase == 3) {  // x2 = x + tanh(gate) * out-projection, kept fp32
    auto r = resumed<W, false, kMaxNt>(a.wout, nullptr, a.dm, inner, a.plan[1], a.b, smem);
    rows::stream_consume<W, float, false, kB, bf16, bf16, true, kMaxNt, true>(
        r, a.attn, none, none, a.eps, rows::kLayerNorm, a.ep3, a.x2, a.b, a.dm, inner, a.plan[1], a.split, smem, nb,
        blk);
    issue<W, kGated, kMaxNt>(a.w1, a.w1g, a.k2, a.dm, a.plan[2], a.b, smem);
  } else if constexpr (kPhase == 4) {  // u from LN2 of the fp32 x2, rounded to bf16 (K2's launch 1)
    auto r = resumed<W, kGated, kMaxNt>(a.w1, a.w1g, a.k2, a.dm, a.plan[2], a.b, smem);
    rows::stream_consume<W, bf16, kGated, kAct, float, bf16, true, kMaxNt, true>(
        r, a.x2, a.ln2_s, a.ln2_b, a.eps, rows::kLayerNorm, a.ep4, a.u, a.b, a.k2, a.dm, a.plan[2], a.split, smem, nb,
        blk);
    issue<W, false, kMaxNt>(a.w2, nullptr, a.dm, a.k2, a.plan[3], a.b, smem);
  } else {  // y = x2 + tanh(gate2) * down-projection, the fp32 x2 as the residual (K2's launch 2)
    auto r = resumed<W, false, kMaxNt>(a.w2, nullptr, a.dm, a.k2, a.plan[3], a.b, smem);
    rows::stream_consume<W, bf16, false, kB, bf16, float, true, kMaxNt, true>(
        r, a.u, none, none, a.eps, rows::kLayerNorm, a.ep5, a.y, a.b, a.dm, a.k2, a.plan[3], a.split, smem, nb, blk);
  }
}

// bf16: the phases between grid barriers; past 8 rows a split's partials
// are added by the whole grid after one more barrier
template <typename W, int kAct, bool kGated, int kMaxNt>
__device__ __forceinline__ void stream_layer(const Layer<bf16>& a, const cooperative_groups::grid_group& grid) {
  constexpr int kB = rows::kActBase;
  // 1. the projection
  stream_phase<1, W, kAct, kGated, kMaxNt>(a);
  grid.sync();
  if (deferred<W, kMaxNt>(a.plan[0], a.dm)) {
    rows::stream_reduce_pass<W, false, kB, float, bf16>(a.split.scratch, a.ep1, a.proj, a.b, a.p, a.dm, a.plan[0]);
    grid.sync();
  }
  // 2. the attend; the scores in the h-slice region, idle until phase 3's first h slice
  attend_phase(a, rows::Geometry<kMaxNt, false>::kRingBytes);
  grid.sync();
  // 3. the out-projection
  stream_phase<3, W, kAct, kGated, kMaxNt>(a);
  grid.sync();
  if (deferred<W, kMaxNt>(a.plan[1], a.h * a.d)) {
    rows::stream_reduce_pass<W, false, kB, float, bf16>(a.split.scratch, a.ep3, a.x2, a.b, a.dm, a.h * a.d,
                                                        a.plan[1]);
    grid.sync();
  }
  // 4. the hidden activation
  stream_phase<4, W, kAct, kGated, kMaxNt>(a);
  grid.sync();
  if (deferred<W, kMaxNt>(a.plan[2], a.dm)) {
    rows::stream_reduce_pass<W, kGated, kAct, bf16, bf16>(a.split.scratch, a.ep4, a.u, a.b, a.k2, a.dm, a.plan[2]);
    grid.sync();
  }
  // 5. y = x2 + tanh(gate2) * down-projection
  stream_phase<5, W, kAct, kGated, kMaxNt>(a);
  if (deferred<W, kMaxNt>(a.plan[3], a.k2)) {
    grid.sync();
    rows::stream_reduce_pass<W, false, kB, bf16, float>(a.split.scratch, a.ep5, a.y, a.b, a.dm, a.k2, a.plan[3]);
  }
}

// fp32: K3's and K2's CUDA-core body in every phase (a.pass_rows rows a pass)
template <typename W, int kAct, bool kGated>
__device__ __forceinline__ void core_layer(const Layer<float>& a, unsigned char* smem,
                                           const cooperative_groups::grid_group& grid) {
  constexpr int kB = rows::kActBase;
  const float* none = nullptr;
  auto w = [](const void* p) { return static_cast<const unsigned char*>(p); };
  rows::gemv_body<float, W, float, false, kB, float, float, true>(a.x, a.ln1_s, a.ln1_b, a.eps, rows::kLayerNorm,
                                                                  w(a.wq), nullptr, a.ep1, a.proj, a.b, a.p, a.dm,
                                                                  a.pass_rows[0], smem, gridDim.x, blockIdx.x);
  grid.sync();
  attend_phase(a, 0);  // the scores over the staged rows
  grid.sync();
  rows::gemv_body<float, W, float, false, kB, float, float, true>(a.attn, none, none, a.eps, rows::kLayerNorm,
                                                                  w(a.wout), nullptr, a.ep3, a.x2, a.b, a.dm,
                                                                  a.h * a.d, a.pass_rows[1], smem, gridDim.x,
                                                                  blockIdx.x);
  grid.sync();
  rows::gemv_body<float, W, float, kGated, kAct, float, float, true>(a.x2, a.ln2_s, a.ln2_b, a.eps,
                                                                     rows::kLayerNorm, w(a.w1), w(a.w1g), a.ep4, a.u,
                                                                     a.b, a.k2, a.dm, a.pass_rows[2], smem, gridDim.x,
                                                                     blockIdx.x);
  grid.sync();
  rows::gemv_body<float, W, float, false, kB, float, float, true>(a.u, none, none, a.eps, rows::kLayerNorm, w(a.w2),
                                                                  nullptr, a.ep5, a.y, a.b, a.dm, a.k2,
                                                                  a.pass_rows[3], smem, gridDim.x, blockIdx.x);
}

template <typename T, typename W, int kAct, bool kGated, int kMaxNt>
__global__ void __launch_bounds__(rows::kThreads, 1) fused_layer_kernel(const __grid_constant__ Layer<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if constexpr (std::is_same<T, bf16>::value) stream_layer<W, kAct, kGated, kMaxNt>(a, grid);
  else core_layer<W, kAct, kGated>(a, smem, grid);
}

// The CUDA-core body's rows per pass for K within `avail` bytes (0: none
// fit), and the blocks it has work for over N columns
inline int core_pass(int k, int b, size_t avail) {
  return (int)std::min<size_t>(std::min<size_t>(avail / ((size_t)k * sizeof(float)), rows::kMaxRows), (size_t)b);
}

template <typename T, typename W, int kAct, bool kGated, int kMaxNt>
cudaError_t launch(Layer<T> a, cudaStream_t st) {
  auto kern = fused_layer_kernel<T, W, kAct, kGated, kMaxNt>;
  static size_t static_smem = ~(size_t)0;
  if (static_smem == ~(size_t)0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    static_smem = fa.sharedSizeBytes;
  }
  const size_t statics = kAttendStatics * sizeof(float);
  const size_t optin = (size_t)rows::smem_optin() - static_smem;
  // (N, K) of the projection, the out-projection, up and down
  const int dims[4][2] = {{a.p, a.dm}, {a.dm, a.h * a.d}, {a.k2, a.dm}, {a.dm, a.k2}};
  int work = a.b * a.h;
  size_t smem;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int i = 0; i < 4; ++i) {
      if (!rows::stream_plan_ok<W>(a.plan[i], a.split, dims[i][0], dims[i][1])) return cudaErrorInvalidValue;
      work = std::max(work, a.plan[i].blocks);
    }
    a.split.defer = kMaxNt != 1;  // past 8 rows the grid adds a split's partials after a barrier
    a.stats = rows::Geometry<kMaxNt, kGated>::kSmem;
    smem = a.stats + statics;
  } else {
    size_t region = std::max<size_t>((size_t)a.s, (size_t)kAttnThreads * rows::kVec) * sizeof(float);
    for (int i = 0; i < 4; ++i) {
      a.pass_rows[i] = core_pass(dims[i][1], a.b, optin - std::min(optin, statics));
      if (a.pass_rows[i] < 1) return cudaErrorInvalidValue;
      region = std::max(region, (size_t)a.pass_rows[i] * dims[i][1] * sizeof(float));
      work = std::max(work, rows::grid_for(((long long)dims[i][0] + rows::kWarps - 1) / rows::kWarps));
    }
    a.stats = (region + 15) / 16 * 16;
    smem = a.stats + statics;
  }
  if (smem > optin) return cudaErrorInvalidValue;
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
// gated form (SwiGLU) with any activation; in bf16 each for B <= 8 (one
// n-tile) and past 8 rows
template <typename T, typename W, int kMaxNt>
cudaError_t launch_act(const Layer<T>& a, cudaStream_t st) {
  if (a.w1g != nullptr) return launch<T, W, rows::kActRuntime, true, kMaxNt>(a, st);
  if (a.ep4.act <= rows::kGelu) return launch<T, W, rows::kActBase, false, kMaxNt>(a, st);
  return launch<T, W, rows::kActRuntime, false, kMaxNt>(a, st);
}

template <typename T, typename W>
cudaError_t launch_rows(const Layer<T>& a, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.b <= 8) return launch_act<T, W, 1>(a, st);
    return launch_act<T, W, 8>(a, st);
  } else {
    return launch_act<T, W, 0>(a, st);
  }
}

template <typename T>
int layer(const void* x, const void* ln1_s, const void* ln1_b, const void* wq, const void* wq_scale, const void* wout,
          const void* wout_scale, void* k, void* v, const void* mask, const void* slopes, const void* gate,
          const void* slot, const void* w1, const void* w1g, const void* w2, const void* w1_scale,
          const void* w1g_scale, const void* w2_scale, const void* b1, const void* b2, const void* ln2_s,
          const void* ln2_b, const void* gate2, void* proj, void* attn, void* x2, void* u, void* y, int b, int dm, int h,
          int d, int s, int k2, int fused_qkv, int has_clip, int wtype, int act, float clip, float scale, float eps,
          const rows::StreamPlan* plans, rows::StreamSplit split, cudaStream_t st) {
  Layer<T> a = {};
  for (int i = 0; i < 4; ++i) a.plan[i] = plans[i];
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
    case 0: return (int)launch_rows<T, T>(a, st);
    case 1: return (int)launch_rows<T, int8_t>(a, st);
    case 2: return (int)launch_rows<T, rows::Int4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, D); ln1_s/ln1_b, ln2_s/ln2_b (D,); wq (3*H*Dh or H*Dh, D), wout
// (D, H*Dh), w1 (K2, D), w1g (K2, D) or NULL (SwiGLU), w2 (D, K2), all in
// x's dtype, int8 or packed int4 as wtype says (0, 1, 2: one stored type for
// every weight), with wq_scale / wout_scale / w1_scale / w1g_scale /
// w2_scale (rows,) fp32 for an int weight, else NULL; k/v (B, H, S <= 8192,
// Dh <= 128, a multiple of 8) in x's dtype; mask (B, S) uint8; slopes (H,)
// fp32 or NULL; gate / gate2 (1,) or NULL; slot (1,) int32 on the device
// (fused_qkv); b1 (K2,), b2 (D,) or NULL; scratch proj (B, 3*H*Dh or H*Dh)
// fp32, attn (B, H*Dh), x2 (B, D) fp32, u (B, K2); out y (B, D). act:
// rows::Act. dtype 0 = fp32, 1 = bf16. D, H*Dh and K2 multiples of 8. bf16
// only: (slice, blocks) of the projection, the out-projection, up and down,
// the plans of K3's and K2's launches (ops/dense_stream.py `stream_plan`);
// scratch for the largest split's partials of every pass of 64 rows and the
// counters, as fused_mlp_fwd's. Returns the launch's CUDA error code (a
// refused cooperative launch included).
extern "C" int fused_layer_decode_fwd(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wq, const void* wq_scale, const void* wout,
    const void* wout_scale, void* k, void* v, const void* mask, const void* slopes, const void* gate,
    const void* slot, const void* w1, const void* w1g, const void* w2, const void* w1_scale, const void* w1g_scale,
    const void* w2_scale, const void* b1, const void* b2, const void* ln2_s, const void* ln2_b, const void* gate2,
    void* proj, void* attn, void* x2, void* u, void* y, int b, int dm, int h, int d, int s, int k2, int fused_qkv,
    int has_clip, int wtype, int act, float clip, float scale, float eps, int slice1, int blocks1, int slice3,
    int blocks3, int slice4, int blocks4, int slice5, int blocks5, void* scratch, void* counters, int ncount,
    int dtype, void* stream) {
  if (d < rows::kVec || d > kMaxD || d % rows::kVec != 0 || b < 1 || h < 1 || s < 1 || s > kMaxS ||
      dm < rows::kVec || dm % rows::kVec != 0 || k2 < rows::kVec || k2 % rows::kVec != 0)
    return (int)cudaErrorInvalidValue;
  if ((fused_qkv && slot == nullptr) || act < rows::kNone || act > rows::kSilu ||
      (w1g_scale != nullptr && w1g == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const rows::StreamPlan plans[4] = {{slice1, blocks1}, {slice3, blocks3}, {slice4, blocks4}, {slice5, blocks5}};
  const rows::StreamSplit split{(float*)scratch, (int*)counters, ncount, 0};
  if (dtype == 0)
    return layer<float>(x, ln1_s, ln1_b, wq, wq_scale, wout, wout_scale, k, v, mask, slopes, gate, slot, w1, w1g, w2,
                        w1_scale, w1g_scale, w2_scale, b1, b2, ln2_s, ln2_b, gate2, proj, attn, x2, u, y, b, dm, h, d,
                        s, k2, fused_qkv, has_clip, wtype, act, clip, scale, eps, plans, split, st);
  if (dtype == 1)
    return layer<bf16>(x, ln1_s, ln1_b, wq, wq_scale, wout, wout_scale, k, v, mask, slopes, gate, slot, w1, w1g, w2,
                       w1_scale, w1g_scale, w2_scale, b1, b2, ln2_s, ln2_b, gate2, proj, attn, x2, u, y, b, dm, h, d, s,
                       k2, fused_qkv, has_clip, wtype, act, clip, scale, eps, plans, split, st);
  return (int)cudaErrorInvalidValue;
}
