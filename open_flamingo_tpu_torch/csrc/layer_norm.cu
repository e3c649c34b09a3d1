// K10 one-pass LayerNorm for Hopper (sm_90a): the ViT blocks' layer_norm1
// and layer_norm2.
//
//   replaces open_flamingo_tpu/ops/layer_norm.py `layer_norm` (kernel
//   `_ln_kernel`): flax semantics, fp32 statistics with the fast variance
//   var = max(0, E[x^2] - E[x]^2), y = (x - mean) * rsqrt(var + eps) *
//   scale (+ bias) in fp32, rounded to x's dtype.
//
// Design and bound. A LayerNorm reads each element once and writes it once
// with a handful of FLOPs: the bytes over 3.35 TB/s are the floor (x in,
// y out, scale and bias once). One warp per row: each lane loads 8
// contiguous elements per step (one 16-byte load in bf16, two in fp32) and
// keeps them in registers, so x is read from device memory once; the two
// sums (x and x^2) are reduced with shuffles, and the lane writes its
// elements back from the same registers. 8 rows per block of 256 threads,
// a grid over the rows. The TPU kernel's row blocks (`block_m`) have no
// counterpart: a row is a warp's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kVec = 8;  // elements a lane loads per step
constexpr int kMaxD = 32 * kVec * 16;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NV steps of 8 elements per lane: rows of up to 32 * 8 * NV elements.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    T* __restrict__ out, int m, int d, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= m) return;
  const T* xr = x + (size_t)row * d;
  T* yr = out + (size_t)row * d;

  float v[NV][kVec];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < d) {
      load8(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s1 += v[i][e];
        s2 = fmaf(v[i][e], v[i][e], s2);
      }
    }
  }
  const float mean = warp_sum(s1) / (float)d;
  const float var = fmaxf(0.f, warp_sum(s2) / (float)d - mean * mean);
  const float r = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < d) {
      float sc[kVec], y[kVec];
      load8(scale + c, sc);
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = (v[i][e] - mean) * r * sc[e];
      if (bias != nullptr) {
        float bi[kVec];
        load8(bias + c, bi);
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[e] += bi[e];
      }
      store8(yr + c, y);
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, const T* scale, const T* bias, T* out, int m, int d, float eps,
                   cudaStream_t st) {
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock);
  const int steps = (d + 32 * kVec - 1) / (32 * kVec);
  if (steps <= 1) {
    layer_norm_kernel<T, 1><<<grid, kThreads, 0, st>>>(x, scale, bias, out, m, d, eps);
  } else if (steps <= 2) {
    layer_norm_kernel<T, 2><<<grid, kThreads, 0, st>>>(x, scale, bias, out, m, d, eps);
  } else if (steps <= 4) {
    layer_norm_kernel<T, 4><<<grid, kThreads, 0, st>>>(x, scale, bias, out, m, d, eps);
  } else if (steps <= 8) {
    layer_norm_kernel<T, 8><<<grid, kThreads, 0, st>>>(x, scale, bias, out, m, d, eps);
  } else {
    layer_norm_kernel<T, 16><<<grid, kThreads, 0, st>>>(x, scale, bias, out, m, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out (M, D) row-major; scale (D,); bias (D,) or NULL; all one dtype,
// 16-byte aligned, D a multiple of 8 and at most 4096. dtype 0 = fp32,
// 1 = bf16.
extern "C" int layer_norm_fwd(const void* x, const void* scale, const void* bias, void* out, int m,
                              int d, float eps, int dtype, void* stream) {
  if (d < kVec || d % kVec != 0 || d > kMaxD || m < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch((const float*)x, (const float*)scale, (const float*)bias, (float*)out, m, d,
                       eps, st);
  return (int)launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
                     (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, m, d, eps, st);
}
