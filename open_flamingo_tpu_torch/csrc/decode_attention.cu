// K7 decode attention for Hopper (sm_90a): one query token per sequence
// over the head-major (B, H, S, Dh) cache.
//
//   replaces open_flamingo_tpu/ops/decode_attention.py `_decode_kernel`
//   via `_call`, as both `decode_attention` (static K/V, e.g. the media
//   K/V cached at prefill) and `decode_attention_update` (write the new
//   token's K/V at `slot`, then attend, in one launch).
//
// Masking: a (B, S) validity mask (pad and causality folded in by the
// caller), optional ALiBi slope_h * (j - (S - 1)). A row with no valid key
// produces exact zeros, which the cross-attention decode relies on for
// text before the first image.
//
// Bound. One query row is a matrix-vector product: 4 FLOPs per cache
// element read, far below the ~295 FLOP/byte at which the H100 stops being
// memory-bound, so the cache bytes over 3.35 TB/s are the floor; at short
// caches (S 64: 0.3-1.6 us of bytes) the launch is.
//
// Design: a split over S, merged in one launch.
//  - The plan (Python `ops.decode_attention.decode_plan`, a function of S,
//    Dh and the dtype alone, never of B or H) cuts a (b, h)'s keys into
//    `splits` chunks of `chunk` keys. Each chunk is one block of 8 warps;
//    the `splits` blocks of a (b, h) form one thread block cluster (at
//    most 8, the portable size). Past 8 splits the chunk grows, so any
//    cache length runs.
//  - A block stages its chunk in tiles of kTile keys through a ring of
//    `stages` tiles in shared memory. A (b, h)'s K (and V) rows are
//    contiguous, so a tile is one 1-D bulk copy (`cp.async.bulk`, TMA's
//    copy without a tensor map) for K and one for V, each counted on an
//    `mbarrier`: all the copies the ring holds at once, then each half of
//    a stage again as soon as the last warp is done with it (K after the
//    scores, V after P.V), so the next K streams in under this tile's P.V.
//    Where a row is not 16-byte aligned (Dh * size % 16 != 0, or a
//    misaligned view) the block copies each tile itself into rows padded
//    with zeros to 16 bytes.
//  - No block barrier in the loop: each warp owns 8 keys of a tile and
//    keeps its own running softmax (m, l, acc). Lanes own 16-byte columns
//    of a key: a group of G lanes (the row's 16-byte vectors, rounded up to
//    a power of two) holds one key, so a warp reads 32 / G whole rows at
//    once. Scores: a dot over the lane's 8 (bf16) or 4 (fp32) columns,
//    summed over the group by shuffles, kept in base 2 (log2 e folded into
//    q's scale and the slope) so each weight is one exp2; the warp's max
//    by shuffles; P.V: each lane adds p * V over its group's keys. The mask
//    bytes of the next tile are read (one a lane, one ballot) while this
//    one is worked on. At the end the warp's groups and then the block's
//    warps meet in a fixed order.
//  - Masked keys (and rows past S in the last tile) are selects, never
//    multiplies: their score is -inf, and a key of weight 0 reads a row of
//    zeros in place of its V row, so a masked row may hold anything, the
//    NaN of an unwritten slot included, and never reaches the output.
//  - The merge: every block stores (m, l, acc[Dh]) into rank 0's shared
//    memory through distributed shared memory (`mapa` + st.shared::cluster)
//    after a cluster barrier that says every block has started, and
//    arrives once on an `mbarrier` in rank 0 (release at cluster scope);
//    the other ranks leave at once, and rank 0, once the barrier says every
//    partial has landed (acquire), rescales and adds them in rank order and
//    stores the output. A chunk with no valid key adds 0 (its factor is
//    2^-inf = 0); a (b, h) with no valid key anywhere stores exact zeros.
//    No global scratch, no second launch, no global atomics: a (b, h) row
//    gives the same bits alone, in any batch and on every repeat.
//  - The update MUTATES the cache in place: only the block whose chunk holds
//    `slot` writes k_new / v_new, after its tile has landed, into its shared
//    copy (the new token takes part in this step's attention) and into the
//    cache. No other block reads that row.
//  - On an H100 (PERF.md, `chip_profile.py k7`): the bf16 S 64 cases take
//    3-6 us, the launch's floor; LLaMA-7B's S 2,048 at B 8 runs within 6% of
//    the same kernel with its compute skipped (the loads alone).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kTile = 64;                // keys a ring stage holds (ops/decode_attention.py DECODE_TILE)
constexpr int kMaxSplits = 8;            // blocks of a (b, h): one portable cluster
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 200 * 1024;     // dynamic bytes: the ring

template <typename T>
struct Args {
  const T* q;
  T* k;        // not const: the update writes the slot's row
  T* v;
  const uint8_t* mask;
  const float* slopes;
  const T* k_new;
  const T* v_new;
  T* out;
  int h, s, d;
  int ld;      // a staged row's elements: d rounded up to 16 bytes
  int slot, chunk, splits, stages;
  float scale;
  int bulk;    // rows 16-byte aligned: tiles arrive by cp.async.bulk
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// A wait that has not completed after ~2^34 clocks (seconds) traps: the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void watchdog(long long start) {
  if (clock64() - start > (1ll << 34)) __trap();
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long start = clock64();
  unsigned done;
  for (;;) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(a), "r"(parity)
                 : "memory");
    if (done) return;
    watchdog(start);
  }
}
// `bytes` contiguous bytes of global memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }
// one arrival on the barrier at `addr` in another block's shared memory (a
// mapped address), releasing this thread's and its block's prior writes at
// cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(unsigned addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
// until the barrier's phase of this parity has completed, acquiring at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long start = clock64();
  unsigned done;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, "
        "p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    watchdog(start);
  }
}
// a shared-memory address of this block as the same address in block `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void store_cluster(unsigned addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of shared memory as floats: 4 fp32 or 8 bf16 values
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Scores are kept in base 2 (log2 e folded into q's scale and the ALiBi
// slope), so each softmax weight is one exp2.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_score(float x) { return exp2f(x); }

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block per (b, h, split) in clusters of `splits`; G lanes per key.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Args<T> a) {
  constexpr int VE = 16 / sizeof(T);                         // elements of a 16-byte column
  constexpr int kGpw = 32 / G;                               // groups (keys at once) of a warp
  constexpr int kKpw = kTile / kWarps;                       // a warp's keys of a tile
  constexpr int kKeys = (kKpw + kGpw - 1) / kGpw;            // a group's keys of a tile
  static_assert(kKpw <= 32, "a warp's keys of a tile are the bits of one ballot");
  extern __shared__ __align__(128) unsigned char ring[];     // stages x (K tile, V tile); the warps' (m, l, acc) after
  __shared__ __align__(16) float zero_s[kMaxD];              // the V row a key of weight 0 reads
  __shared__ float part[kMaxSplits][kMaxD + 2];              // rank 0's: each split's (m, l, acc)
  __shared__ unsigned done_s[2 * kMaxStages];                // per stage: warps done with its K, with its V
  __shared__ __align__(8) uint64_t full[2 * kMaxStages];     // per stage: K landed, V landed
  __shared__ __align__(8) uint64_t merged;                   // rank 0's: every split's partial has landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = lane / G, c = lane % G;                     // the lane's group in its warp, its column
  const int split = blockIdx.x % a.splits, bh = blockIdx.x / a.splits;
  const int b = bh / a.h, head = bh % a.h;
  const int k0 = split * a.chunk, k1 = min(a.s, k0 + a.chunk);
  const int tiles = k1 > k0 ? (k1 - k0 + kTile - 1) / kTile : 0;
  const int ld = a.ld, nv = ld / VE;
  const size_t row0 = (size_t)bh * a.s;                      // the (b, h)'s first cache row
  const int tile_elems = kTile * ld;
  T* const ring0 = reinterpret_cast<T*>(ring);

  for (int i = tid; i < kMaxD; i += kThreads) zero_s[i] = 0.f;
  if (tid < 2 * kMaxStages) done_s[tid] = 0;
  if (tid == 0) {
    if (a.bulk)
      for (int i = 0; i < 2 * a.stages; ++i) mbar_init(&full[i], 1);
    mbar_init(&merged, a.splits);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (a.splits > 1) cluster_arrive_relaxed();   // this block has started (waited on before the merge)

  // tile t's K (half 0) or V (half 1) into stage t % stages
  auto issue = [&](int t, int half) {
    const int st = t % a.stages, r0 = k0 + t * kTile;
    const unsigned bytes = (unsigned)(min(kTile, k1 - r0) * ld * (int)sizeof(T));
    mbar_expect_tx(&full[2 * st + half], bytes);
    bulk_load(ring0 + (size_t)(2 * st + half) * tile_elems, (half ? a.v : a.k) + (row0 + r0) * ld, bytes,
              &full[2 * st + half]);
  };
  // a warp is done with a stage's half: the last warp to finish refills it with tile t + stages
  auto release = [&](int t, int half) {
    __syncwarp();
    if (lane == 0) {
      const int st = t % a.stages;
      __threadfence_block();
      if (atomicAdd(&done_s[2 * st + half], 1u) == kWarps - 1) {
        done_s[2 * st + half] = 0;
        if (t + a.stages < tiles) issue(t + a.stages, half);
      }
    }
  };
  if (a.bulk && tid == 0)
    for (int t = 0; t < min(a.stages, tiles); ++t) {
      issue(t, 0);
      issue(t, 1);
    }

  // the lane's columns of q, times the scale (and log2 e); zeros past Dh
  float qv[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const int col = c * VE + e;
    qv[e] = c < nv && col < a.d ? to_f32(a.q[(size_t)bh * a.d + col]) * (a.scale * kLog2e) : 0.f;
  }
  const float slope = a.slopes != nullptr ? a.slopes[head] * kLog2e : 0.f;
  const uint8_t* mrow = a.mask + (size_t)b * a.s;
  const int slot_tile = a.k_new != nullptr && a.slot >= k0 && a.slot < k1 ? (a.slot - k0) / kTile : -1;

  // the warp owns keys [warp * kKpw, (warp + 1) * kKpw) of each tile; the
  // group's i-th is gw + i * kGpw of them, so a warp reads whole rows at once
  auto key = [&](int i) { return warp * kKpw + gw + i * kGpw; };
  // the validity of the warp's keys of tile t, one bit a key (one mask byte a lane)
  auto valid = [&](int t) {
    const int kj = k0 + t * kTile + warp * kKpw + lane;
    return __ballot_sync(0xffffffffu, t < tiles && lane < kKpw && kj < k1 && mrow[kj] != 0);
  };
  // the warp's running softmax over its keys: m, l and the group's columns of acc
  float m_w = -INFINITY, l = 0.f, acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;
  unsigned ok = valid(0);

  for (int t = 0; t < tiles; ++t) {
    const int st = t % a.stages, r0 = k0 + t * kTile;
    const unsigned parity = (t / a.stages) & 1;
    T* ks = ring0 + (size_t)st * 2 * tile_elems;
    T* vs = ks + tile_elems;
    const unsigned ok_next = valid(t + 1);   // the next tile's, read while this one is worked on
    if (a.bulk) {
      mbar_wait(&full[2 * st], parity);
    } else {
      // rows not 16-byte aligned: the block stages the tile itself, each
      // row padded with zeros to ld (the last tile's rows past the chunk:
      // zeros too), once every warp is done with the previous tile
      __syncthreads();
      const int rows = min(kTile, k1 - r0);
      for (int i = tid; i < tile_elems; i += kThreads) {
        const int r = i / ld, col = i % ld;
        T kx = T(0.f), vx = T(0.f);
        if (r < rows && col < a.d) {
          const size_t g = (row0 + r0 + r) * a.d + col;
          kx = a.k[g];
          vx = a.v[g];
        }
        ks[i] = kx;
        vs[i] = vx;
      }
      __syncthreads();
    }
    if (t == slot_tile) {   // block-uniform: the new token's row, over what landed
      if (a.bulk) mbar_wait(&full[2 * st + 1], parity);
      const int r = a.slot - r0;
      for (int col = tid; col < a.d; col += kThreads) {
        const T kn = a.k_new[(size_t)bh * a.d + col], vn = a.v_new[(size_t)bh * a.d + col];
        ks[r * ld + col] = kn;
        vs[r * ld + col] = vn;
        a.k[(row0 + a.slot) * a.d + col] = kn;
        a.v[(row0 + a.slot) * a.d + col] = vn;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // before the stage's next bulk copy
      __syncthreads();
    }

    // scores: a dot over the lane's columns, summed over the group
    float sc[kKeys], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      float dot = 0.f;
      if (c < nv && gw + i * kGpw < kKpw) {
        float kf[VE];
        load16(ks + key(i) * ld + c * VE, kf);
#pragma unroll
        for (int e = 0; e < VE; ++e) dot = fmaf(qv[e], kf[e], dot);
      }
      dot = group_sum<G>(dot);
      const bool live = gw + i * kGpw < kKpw && (ok >> (gw + i * kGpw) & 1u);
      sc[i] = live ? dot + slope * (float)(r0 + key(i) - (a.s - 1)) : -INFINITY;
      mx = fmaxf(mx, sc[i]);
    }
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));   // over the warp
    const float m_new = fmaxf(m_w, mx);
    if (a.bulk) {
      release(t, 0);   // K read: its refill streams in under P.V
      mbar_wait(&full[2 * st + 1], parity);
    }
    if (m_new != -INFINITY) {   // warp-uniform
      const float alpha = exp_score(m_w - m_new);              // 0 while no key was valid
      l *= alpha;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float p = exp_score(sc[i] - m_new);              // 0 where masked
        l += p;
        if (c < nv && gw + i * kGpw < kKpw) {
          // a key of weight 0 (masked) reads the zero row: a select, so its V never reaches the sums
          const T* vrow = p != 0.f ? vs + key(i) * ld : reinterpret_cast<const T*>(zero_s);
          float vf[VE];
          load16(vrow + c * VE, vf);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
        }
      }
      m_w = m_new;
    }
    if (a.bulk) release(t, 1);
    ok = ok_next;
  }

  // the warp's groups into one (l, acc) (one m across the warp), then the
  // warps' into the chunk's, warp by warp (every tile is consumed and no
  // copy is in flight: the ring holds the warps' partials)
  float(*part_w)[kMaxD + 2] = reinterpret_cast<float(*)[kMaxD + 2]>(ring);
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  __syncthreads();   // every warp is done with the ring
  if (gw == 0 && c < nv) {
#pragma unroll
    for (int e = 0; e < VE; ++e) part_w[warp][2 + c * VE + e] = acc[e];
  }
  if (lane == 0) {
    part_w[warp][0] = m_w;
    part_w[warp][1] = l;
  }
  __syncthreads();
  float m_b = -INFINITY, l_b = 0.f, a_b = 0.f;
  if (tid < a.d) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_b = fmaxf(m_b, part_w[w][0]);
    if (m_b != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp_score(part_w[w][0] - m_b);        // a warp with no valid key: 0
        a_b = fmaf(part_w[w][2 + tid], f, a_b);
        l_b = fmaf(part_w[w][1], f, l_b);
      }
    }
  }
  T* out = a.out + (size_t)bh * a.d;
  if (a.splits == 1) {
    if (tid < a.d) store(&out[tid], m_b == -INFINITY ? 0.f : a_b / l_b);
    return;
  }

  // the merge: every split's (m, l, acc) into rank 0's shared memory and
  // one arrival on rank 0's barrier; the other ranks are then done (they
  // leave while rank 0 waits), rank 0 adds the partials in rank order
  cluster_wait();   // every block of the cluster has started: rank 0's barrier is initialized
  const unsigned dst = map_rank(smem_u32(&part[split][0]), 0);
  if (tid == 0) {
    store_cluster(dst, m_b);
    store_cluster(dst + 4, l_b);
  }
  if (tid < a.d) store_cluster(dst + 4 * (2 + tid), a_b);
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) mbar_arrive_cluster(map_rank(smem_u32(&merged), 0));
  if (split != 0 || tid >= a.d) return;
  mbar_wait_cluster(&merged, 0);
  float mm = -INFINITY;
  for (int r = 0; r < a.splits; ++r) mm = fmaxf(mm, part[r][0]);
  float o = 0.f;
  if (mm != -INFINITY) {
    float num = 0.f, den = 0.f;
    for (int r = 0; r < a.splits; ++r) {
      const float f = exp_score(part[r][0] - mm);   // a split with no valid key: 0
      num = fmaf(part[r][2 + tid], f, num);
      den = fmaf(part[r][1], f, den);
    }
    o = num / den;
  }
  store(&out[tid], o);
}

// Raise the kernel's dynamic shared-memory limit once to the most any call can ask for.
template <auto Kern>
cudaError_t allow_smem() {
  static bool done = false;   // one flag per kernel (internal linkage)
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int G>
cudaError_t launch(const Args<T>& a, int bh, size_t smem, cudaStream_t st) {
  cudaError_t err = allow_smem<decode_split_kernel<T, G>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bh * a.splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_split_kernel<T, G>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// G: the row's 16-byte vectors rounded up to a power of two
template <typename T>
cudaError_t dispatch(const Args<T>& a, int bh, size_t smem, cudaStream_t st) {
  const int nv = a.ld * (int)sizeof(T) / 16;
  if (nv <= 1) return launch<T, 1>(a, bh, smem, st);
  if (nv <= 2) return launch<T, 2>(a, bh, smem, st);
  if (nv <= 4) return launch<T, 4>(a, bh, smem, st);
  if (nv <= 8) return launch<T, 8>(a, bh, smem, st);
  if (nv <= 16) return launch<T, 16>(a, bh, smem, st);
  if constexpr (sizeof(T) == 4) return launch<T, 32>(a, bh, smem, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, void* k, void* v, const void* mask, const void* slopes, const void* k_new, const void* v_new,
        void* out, int b, int h, int s, int d, int slot, float scale, int chunk, int splits, int stages,
        cudaStream_t st) {
  Args<T> a;
  a.q = (const T*)q;
  a.k = (T*)k;
  a.v = (T*)v;
  a.mask = (const uint8_t*)mask;
  a.slopes = (const float*)slopes;
  a.k_new = (const T*)k_new;
  a.v_new = (const T*)v_new;
  a.out = (T*)out;
  a.h = h;
  a.s = s;
  a.d = d;
  a.ld = (d * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
  a.slot = slot;
  a.chunk = chunk;
  a.splits = splits;
  a.stages = stages;
  a.scale = scale;
  a.bulk = a.ld == d && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t ring = (size_t)stages * 2 * kTile * a.ld * sizeof(T);
  const size_t parts = (size_t)kWarps * (kMaxD + 2) * sizeof(float);   // the warps' partials reuse it
  const size_t smem = ring > parts ? ring : parts;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)dispatch<T>(a, b * h, smem, st);
}

}  // namespace

// q (B, H, D); k/v (B, H, S, D); mask (B, S) uint8; slopes (H,) fp32 or
// NULL; k_new/v_new (B, H, D) or NULL (no update); out (B, H, D).
// dtype 0 = fp32, 1 = bf16. The plan (`decode_plan`): `splits` blocks of
// `chunk` keys (a multiple of kTile) per (b, h), a ring of `stages` tiles.
extern "C" int decode_attention_fwd(const void* q, void* k, void* v, const void* mask, const void* slopes,
                                    const void* k_new, const void* v_new, void* out, int b, int h, int s, int d,
                                    int slot, float scale, int dtype, int chunk, int splits, int stages,
                                    void* stream) {
  if (d < 1 || d > kMaxD || (dtype != 0 && dtype != 1) || s < 0) return (int)cudaErrorInvalidValue;
  if ((k_new == nullptr) != (v_new == nullptr)) return (int)cudaErrorInvalidValue;
  if (k_new != nullptr && (slot < 0 || slot >= s)) return (int)cudaErrorInvalidValue;
  // the plan: every key in one split, every split holding a key (S 0: one empty split)
  if (chunk < kTile || chunk % kTile != 0 || splits < 1 || splits > kMaxSplits || stages < 1 ||
      stages > kMaxStages || (long long)splits * chunk < s ||
      ((long long)(splits - 1) * chunk >= s && !(s == 0 && splits == 1)))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(q, k, v, mask, slopes, k_new, v_new, out, b, h, s, d, slot, scale, chunk, splits, stages, st);
  return run<__nv_bfloat16>(q, k, v, mask, slopes, k_new, v_new, out, b, h, s, d, slot, scale, chunk, splits,
                            stages, st);
}
