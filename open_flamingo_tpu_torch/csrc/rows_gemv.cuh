// Row-batched matrix-vector products for single-token decode on Hopper
// (sm_90a): every fp32 row GEMV of K1, K2, K3, K6 and K11 and of their K2b
// carriers (the CUDA-core body; dense_stream.cu, decode_layer.cu,
// fused_layer.cu, side_tile.cuh), and what the bf16 weight-streaming body of
// rows_stream.cuh shares with it (the weight types, the epilogue, the launch
// helpers).
//
//   out[r, n] = epilogue( sum_k h[r, k] * W[n, k] )     r < B (a few rows)
//
// W is torch's nn.Linear layout (N, K), row-major, read in place: column n
// of the product is one contiguous row of W. h is either x itself, the
// LayerNorm of x (flax fast variance max(0, E[x^2] - E[x]^2) in fp32) or its
// RMSNorm (x * rsqrt(E[x^2] + eps), no mean, no bias; the TPU kernels'
// `_norm_f32(kind="rms")`), times the norm's scale, ROUNDED TO x's DTYPE, as
// the TPU kernels cast the normalised rows before the product. Products
// accumulate in fp32; the epilogue runs in fp32 in the TPU kernels' order:
// +bias -> clip -> act -> *gated product -> *tanh(gate) -> +residual. The
// activations are `_act_f32`'s: exact GELU, gelu_new (tanh form), relu,
// quick_gelu (y * sigmoid(1.702 y)) and silu.
//
// Gated form (K2's SwiGLU, `w1_gate`): a second weight Wg of W's shape and
// storage streams in the same pass, the same column's row of W and of Wg
// against the same staged h, into two fp32 sums; the epilogue multiplies
// act(y) by the second sum (times Wg's scale for an int weight). A template
// parameter: the plain kernels are compiled without it.
//
// Design and bound. At decode batch sizes (B <= 64) every weight element is
// used B times, 2B FLOPs per weight read: far below the ~295 FLOP/byte where
// the H100 stops being memory-bound, so the weight bytes over 3.35 TB/s are
// the floor. Every block stages up to 8 rows of h in shared memory
// (normalised once per block); more rows go in passes that read W again (the
// bf16 body in rows_stream.cuh takes 64 rows a pass and any K). Blocks loop
// over columns with a grid stride, the grid capped at 4 blocks per SM, so
// the normalisation is not repeated per column. Each warp takes one column
// at a time, its lanes read the row 32 bytes a lane, keep one fp32 sum per
// row and end with a shuffle reduction: CUDA cores, the exact-fp32 path
// that the card's fp32 checks run.
//
// Quantized weights (the JAX kernels' int8 / int4 weight streaming). W is
// stored as T itself, as int8, or as packed int4 (`Int4`: two values per
// byte, element 2j in the low nibble of byte j, two's complement): a lane
// loads 8 bytes of int8 (4 of int4) per 8 elements instead of 16 of bf16,
// half or a quarter of the bytes that bound the kernel. The values convert
// to fp32 exactly (|q| <= 127 has at most 8 significant bits) and without a
// conversion instruction (2^23 + 128 + q read as a float). The
// per-out-channel fp32 scale multiplies the fp32 sum first in the epilogue,
// as in the TPU kernels.
//
// Inside one persistent launch (K11, csrc/fused_layer.cu) a body reads rows
// that other blocks of the same launch wrote in an earlier phase: its input
// rows may then be fp32 (X, the layer's fp32 residual stream, normalised and
// rounded to T when staged) and its epilogue's residual fp32 (R), and with
// kCg both are read through L2 alone (ld.global.cg), never through L1 or the
// read-only path, which are not coherent within a launch. The defaults
// (X = R = T, no kCg) are the instances the separate launches compile.
// The kCg instances spell out where a product and a sum round, as the
// separate launches' instances compile them (measured on the card: nvcc
// contracted them differently in the two kernels): the LayerNorm's bias and
// an int weight's scale with a bias fuse into one FMA, y * tanh(gate) +
// residual rounds twice. So K11's fp32 results are K3's and K2's bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rows {
// Internal linkage: each kernel library that includes this header keeps its
// own copies, and its own static state. (A static local of a template with
// external linkage is one process-wide symbol, shared by every library that
// defines it, so one library's cached shared-memory limit would skip the
// other library's cudaFuncSetAttribute.)
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;          // rows per pass, one fp32 sum each per lane
constexpr int kVec = 8;              // elements a lane reads per step
constexpr int kBlocksPerSm = 4;      // 4 x 512 threads fill an SM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 8 consecutive elements (16-byte aligned) to fp32. `ldg`: read-only path,
// for weights that no launch in flight writes.
template <bool ldg>
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 a = ldg ? __ldg(q) : q[0];
  float4 b = ldg ? __ldg(q + 1) : q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <bool ldg>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 u = ldg ? __ldg(q) : q[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 consecutive elements (16-byte aligned) to fp32 through L2 alone
__device__ __forceinline__ void load8cg(const float* p, float* v) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p)), b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8cg(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// an input row's 8 elements: plain loads, or through L2 alone (kCg)
template <bool kCg, typename X>
__device__ __forceinline__ void load8x(const X* p, float* v) {
  if constexpr (kCg) load8cg(p, v);
  else load8<false>(p, v);
}

struct Int4 {};  // the weight storage tag of packed int4

// bytes of one stored weight row of k elements
template <typename W>
__host__ __device__ __forceinline__ size_t w_row_bytes(int k) {
  if constexpr (std::is_same<W, Int4>::value) return (size_t)k / 2;
  else return (size_t)k * sizeof(W);
}

// an int in [-128, 127] as a float, exactly: 2^23 + 128 + x read as a float
__device__ __forceinline__ float small_int_to_f32(int x) { return __int_as_float(0x4B000080 + x) - 8388736.f; }
__device__ __forceinline__ int sbyte(uint32_t w, int i) { return (int)(int8_t)(w >> (8 * i)); }
__device__ __forceinline__ int snibble(uint32_t w, int i) { return (int)((int32_t)(w << (28 - 4 * i)) >> 28); }

// 8 consecutive weights from element c of a stored row, to fp32
template <typename W>
__device__ __forceinline__ void load8w(const unsigned char* row, int c, float* v) {
  if constexpr (std::is_same<W, int8_t>::value) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + c));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = small_int_to_f32(sbyte(u.x, e));
      v[4 + e] = small_int_to_f32(sbyte(u.y, e));
    }
  } else if constexpr (std::is_same<W, Int4>::value) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(row + c / 2));
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = small_int_to_f32(snibble(u, e));
  } else {
    load8<true>(reinterpret_cast<const W*>(row) + c, v);
  }
}

enum Act { kNone = 0, kGelu = 1, kGeluNew = 2, kRelu = 3, kQuickGelu = 4, kSilu = 5 };
enum Norm { kLayerNorm = 0, kRmsNorm = 1 };

template <typename T, typename R = T>
struct Epilogue {
  const float* scale;  // (N,) fp32: an int weight's per-channel scale, y *= scale first
  const T* bias;       // (N,) or null
  int has_clip;
  float clip;          // y = clamp(y, -clip, clip)
  int act;             // an Act
  const T* gate;       // (1,) or null: y *= tanh(gate)
  const R* residual;   // (B, N) or null: y += residual
  const float* gscale; // gated form with an int Wg: its (N,) scale, or null
};

__device__ __forceinline__ float activation(float y, int act) {
  switch (act) {
    // CUDA's erff (max 2 ulp); the TPU kernel uses A&S 7.1.26 (|err| <= 1.5e-7)
    case kGelu: return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    case kGeluNew: return 0.5f * y * (1.f + tanhf(0.79788456080286536f * (y + 0.044715f * y * y * y)));
    case kRelu: return fmaxf(y, 0.f);
    case kQuickGelu: return y / (1.f + expf(-1.702f * y));
    case kSilu: return y / (1.f + expf(-y));
    default: return y;
  }
}

// The activation of a kernel instance: kActBase, none or exact GELU as
// ep.act says (the first instance of each kernel, which keeps the epilogue
// it had before the other activations came); kActRuntime, any Act as ep.act
// says (the CUDA-core kernel's instance for the activations past GELU); or
// one Act compiled in (one weight-streaming instance each). In an earlier
// bf16 tensor-core body a switch over every activation, or no activation
// code at all, changed the compiler's schedule of the whole kernel and cost
// its instances 5-18% of their time (chip_smoke.py's kernels phase, parent
// and change in one run).
constexpr int kActRuntime = -1;
constexpr int kActBase = -2;

// kScaled: an int weight's instantiation, the only one that reads the scale
// (compiled into the bf16 kernel, the branch alone cost it registers and 16%
// of its HBM rate). yg: the gated form's second sum (kGated only). kCg: the
// residual is read through L2 alone, and the roundings are spelled out (see
// the top).
template <bool kScaled, bool kGated, int kAct, bool kCg = false, typename T, typename R>
__device__ __forceinline__ float epilogue(float y, float yg, const Epilogue<T, R>& ep, int r, int col, int n) {
  if constexpr (kScaled && kCg) {
    y = ep.bias != nullptr ? __fmaf_rn(y, ep.scale[col], to_f32(ep.bias[col])) : y * ep.scale[col];
  } else {
    if constexpr (kScaled) y *= ep.scale[col];
    if (ep.bias != nullptr) y += to_f32(ep.bias[col]);
  }
  if (ep.has_clip) y = fminf(fmaxf(y, -ep.clip), ep.clip);
  if constexpr (kAct == kActRuntime) {
    if (ep.act != kNone) y = activation(y, ep.act);
  } else if constexpr (kAct == kActBase) {
    if (ep.act == kGelu) y = activation(y, kGelu);
  } else {
    y = activation(y, kAct);
  }
  if constexpr (kGated) y *= kScaled ? yg * ep.gscale[col] : yg;
  if constexpr (kCg) {
    if (ep.gate != nullptr && ep.residual != nullptr) {
      y = __fadd_rn(__fmul_rn(y, tanhf(to_f32(ep.gate[0]))), to_f32(__ldcg(ep.residual + (size_t)r * n + col)));
    } else {
      if (ep.gate != nullptr) y *= tanhf(to_f32(ep.gate[0]));
      if (ep.residual != nullptr) y += to_f32(__ldcg(ep.residual + (size_t)r * n + col));
    }
  } else {
    if (ep.gate != nullptr) y *= tanhf(to_f32(ep.gate[0]));
    if (ep.residual != nullptr) y += to_f32(ep.residual[(size_t)r * n + col]);
  }
  return y;
}

// One warp stages row `xr` (k elements of X: T, or fp32) into `dst`: a
// copy, or the LayerNorm or RMSNorm (`norm`) rounded to T. RMSNorm takes no
// mean: x - 0 is x, so its rows are x * inv * scale in the TPU kernel's
// order. kCg: xr is read through L2 alone.
template <bool kCg = false, typename T, typename X>
__device__ void stage_row(const X* __restrict__ xr, const T* __restrict__ ln_s,
                          const T* __restrict__ ln_b, float eps, int norm, T* dst, int k, int lane) {
  if (ln_s == nullptr) {  // a copy: T -> fp32 -> T is exact
    for (int c = lane * kVec; c < k; c += 32 * kVec) {
      float v[kVec];
      load8x<kCg>(xr + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[c + e] = from_f32<T>(v[e]);
    }
    return;
  }
  float s = 0.f, ss = 0.f;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    float v[kVec];
    load8x<kCg>(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s += v[e];
      ss = fmaf(v[e], v[e], ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const bool rms = norm == kRmsNorm;
  const float mean = rms ? 0.f : s / (float)k;
  const float var = rms ? ss / (float)k : fmaxf(0.f, ss / (float)k - mean * mean);
  const float inv = rsqrtf(var + eps);
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    float v[kVec];
    load8x<kCg>(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float y;
      if constexpr (kCg) {
        const float p = (v[e] - mean) * inv, s = to_f32(ln_s[c + e]);
        y = ln_b != nullptr ? __fmaf_rn(p, s, to_f32(ln_b[c + e])) : p * s;
      } else {
        y = (v[e] - mean) * inv * to_f32(ln_s[c + e]);
        if (ln_b != nullptr) y += to_f32(ln_b[c + e]);
      }
      dst[c + e] = from_f32<T>(y);
    }
  }
}

// The CUDA-core kernel's body, for block `block` of a grid of `grid` blocks
// (a kernel that carries other blocks too passes its own count). X, R, kCg:
// the input rows' type, the residual's, coherent reads (see the top).
template <typename T, typename W, typename OutT, bool kGated, int kAct, typename X = T, typename R = T,
          bool kCg = false>
__device__ __forceinline__ void gemv_body(
    const X* __restrict__ x, const T* __restrict__ ln_s, const T* __restrict__ ln_b, float eps, int norm,
    const unsigned char* __restrict__ w, const unsigned char* __restrict__ wg, Epilogue<T, R> ep,
    OutT* __restrict__ out, int b, int n, int k, int rows_per_pass, unsigned char* smem, int grid, int block) {
  T* hs = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r0 = 0; r0 < b; r0 += rows_per_pass) {
    const int rb = min(rows_per_pass, b - r0);
    if (r0 > 0) __syncthreads();  // the last pass is done reading hs
    for (int r = warp; r < rb; r += kWarps)
      stage_row<kCg>(x + (size_t)(r0 + r) * k, ln_s, ln_b, eps, norm, hs + (size_t)r * k, k, lane);
    __syncthreads();

    for (int col = block * kWarps + warp; col < n; col += grid * kWarps) {
      float acc[kMaxRows], accg[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] = accg[r] = 0.f;
      const unsigned char* wrow = w + (size_t)col * w_row_bytes<W>(k);
      const unsigned char* grow = (kGated ? wg : w) + (size_t)col * w_row_bytes<W>(k);
#pragma unroll 2
      for (int c = lane * kVec; c < k; c += 32 * kVec) {
        float wv[kVec], gv[kVec];
        load8w<W>(wrow, c, wv);
        if constexpr (kGated) load8w<W>(grow, c, gv);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rb) {
            float hv[kVec];
            load8<false>(hs + (size_t)r * k + c, hv);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              acc[r] = fmaf(hv[e], wv[e], acc[r]);
              if constexpr (kGated) accg[r] = fmaf(hv[e], gv[e], accg[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rb) {  // uniform across the warp
          const float sum = warp_sum(acc[r]);
          const float sumg = kGated ? warp_sum(accg[r]) : 0.f;
          if (lane == r)
            out[(size_t)(r0 + r) * n + col] =
                from_f32<OutT>(epilogue<!std::is_same<W, T>::value, kGated, kAct, kCg>(sum, sumg, ep, r0 + r, col, n));
        }
      }
    }
  }
}

template <typename T, typename W, typename OutT, bool kGated, int kAct>
__global__ void __launch_bounds__(kThreads) gemv_kernel(
    const T* __restrict__ x, const T* __restrict__ ln_s, const T* __restrict__ ln_b, float eps, int norm,
    const unsigned char* __restrict__ w, const unsigned char* __restrict__ wg, Epilogue<T> ep,
    OutT* __restrict__ out, int b, int n, int k, int rows_per_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv_body<T, W, OutT, kGated, kAct>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, rows_per_pass, smem,
                                      gridDim.x, blockIdx.x);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

inline int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// Raise `kern`'s dynamic shared-memory limit to `smem` once; `set` caches
// the limit already granted to that kernel. Keep one cache per kernel: the
// launch function that holds it is the kernel's only launcher (two caches of
// one kernel's limit once let one caller lower it under the other's feet,
// CUDA error 1 at the other's next launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t& set) {
  if (smem <= set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) set = smem;
  return e;
}

inline int grid_for(long long blocks) {
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  return (int)(blocks < cap ? blocks : cap);
}

// The CUDA-core kernel's rows staged per pass for K of type T (0: none fit).
template <typename T>
int core_rows(int b, int k) {
  int rows = (int)((size_t)smem_optin() / ((size_t)k * sizeof(T)));
  rows = rows < kMaxRows ? rows : kMaxRows;
  return rows < b ? rows : b;
}

// The CUDA-core kernel's launch (the fp32 row GEMVs): as many rows per pass
// as fit.
template <typename T, typename W, typename OutT, bool kGated, int kAct>
cudaError_t launch_gemv_core(const T* x, const T* ln_s, const T* ln_b, float eps, int norm, const void* w,
                             const void* wg, Epilogue<T> ep, OutT* out, int b, int n, int k, cudaStream_t st) {
  const int rows = core_rows<T>(b, k);
  if (rows < 1) return cudaErrorInvalidValue;
  const size_t smem = rows * (size_t)k * sizeof(T);
  auto kern = gemv_kernel<T, W, OutT, kGated, kAct>;
  static size_t smem_set = 48 * 1024;  // the default limit
  cudaError_t e = allow_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<grid_for(((long long)n + kWarps - 1) / kWarps), kThreads, smem, st>>>(
      x, ln_s, ln_b, eps, norm, static_cast<const unsigned char*>(w), static_cast<const unsigned char*>(wg), ep,
      out, b, n, k, rows);
  return cudaGetLastError();
}

// out (B, N) = epilogue(h @ W^T); h = norm(x) when ln_s is given (`norm` a
// Norm), else x; W (N, K) stored as W (T, int8_t or Int4); with kGated, Wg
// of the same shape and storage. k must be a multiple of kVec and every row
// 16-byte aligned (the wrapper checks). Returns the launch's error code.
template <typename T, typename W, typename OutT, bool kGated>
cudaError_t launch_gemv(const T* x, const T* ln_s, const T* ln_b, float eps, int norm, const void* w,
                        const void* wg, Epilogue<T> ep, OutT* out, int b, int n, int k, cudaStream_t st) {
  if (k < kVec || k % kVec != 0 || b < 1 || n < 1 || (kGated && wg == nullptr)) return cudaErrorInvalidValue;
  if (ep.act < kNone || ep.act > kSilu) return cudaErrorInvalidValue;
  if (ep.act <= kGelu)
    return launch_gemv_core<T, W, OutT, kGated, kActBase>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
  return launch_gemv_core<T, W, OutT, kGated, kActRuntime>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
}

// launch_gemv on the weight type code the wrappers pass (0 W in T, 1 int8,
// 2 packed int4), the norm kind and any activation; gated with wg (K2's
// SwiGLU), which is stored as w is; every fp32 row GEMV of K1, K2, K3 and
// K6
template <typename T, typename OutT>
cudaError_t launch_gemv_norm(int wtype, const T* x, const T* ln_s, const T* ln_b, float eps, int norm,
                             const void* w, const void* wg, Epilogue<T> ep, OutT* out, int b, int n, int k,
                             cudaStream_t st) {
  if (norm != kLayerNorm && norm != kRmsNorm) return cudaErrorInvalidValue;
  const bool gated = wg != nullptr;
  switch (wtype * 2 + gated) {
    case 0: return launch_gemv<T, T, OutT, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, st);
    case 1: return launch_gemv<T, T, OutT, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
    case 2: return launch_gemv<T, int8_t, OutT, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, st);
    case 3: return launch_gemv<T, int8_t, OutT, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
    case 4: return launch_gemv<T, Int4, OutT, false>(x, ln_s, ln_b, eps, norm, w, nullptr, ep, out, b, n, k, st);
    case 5: return launch_gemv<T, Int4, OutT, true>(x, ln_s, ln_b, eps, norm, w, wg, ep, out, b, n, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rows
