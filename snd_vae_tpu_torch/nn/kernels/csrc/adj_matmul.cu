// adj_matmul: out[b] = act(A[b] @ xw[b]) with xw = X[b] (no W) or
// xw = round_T(X[b] @ W) (GraphConv's projection fused in front, W [F,H]
// shared by the batch), f32 accumulation, act = identity or leaky ReLU
// max(y, leak*y), for f32 or bf16 tensors.
//
// Replaces the TPU kernel blocked_adj_matmul (snd_vae_tpu/nn/pallas/
// blocked_spmm.py:89, body _adj_matmul_kernel :66), which tiles A and X
// through VMEM on a sequential (i, j, k) grid and carries the f32 sum in
// scratch from one k step to the next; with W it also takes the place of
// GraphConv's separate x @ W (snd_vae_tpu/nn/graph_conv.py:40-43).
//
// Rounding: the f32 sum is rounded to the storage type and the activation
// is applied to the rounded value (then rounded again), as the plain
// version and JAX's GraphConv do; the Pallas kernel applies it before the
// rounding.  The two orders agree in f32 and differ by at most one bf16
// ulp on negative outputs.  xw is rounded to the storage type before the
// product, as JAX's xw.astype(x.dtype).
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 on CUDA cores, 989
// bf16 on tensor cores):
//   * served GraphConvs, [10,25,25] @ ([10,25,F] @ [F,H]), F,H = 1,10 and
//     11,20: ~40-60 KB and ~0.2 MFLOP, ~0.02 us: the launch bounds it.
//   * [2048,2048] @ [2048,128]: 1.07 GFLOP; f32 16.0 us of operations,
//     bf16 2.8 us of bytes (9.4 MB).  [8192,8192] @ [8192,128]: f32 256 us
//     of operations, bf16 40 us of bytes (134 MB).
//   * the output is tall and thin: at N = 2048 a 128 x 128 tile grid has 16
//     tiles for 132 SMs, so k has to be split across blocks to fill the card;
//     and a cluster lies in one GPC, so clusters of 4 or 8 reach only 120
//     SMs (cudaOccupancyMaxActiveClusters): a grid that needs more runs a
//     second wave.
//
// Design, three variants; adj_matmul_plan (adj_matmul.py) picks one and its
// sizes from the shapes alone, and the launch below checks what it picked
// against the sizes here and launches it as it stands:
//   small  (a graph's A, X and W fit one block): one block per graph and
//          32-column tile stages A, X and W with 4-byte cp.async (a row of
//          25 floats is 100 B: neither 16-byte pieces nor TMA apply; bf16
//          travels as aligned pairs), forms xw in shared memory, one thread
//          per element with four chains over F, and writes act(A @ xw), one
//          thread per output with four chains over k.  GraphConv is one
//          launch.
//   simt   (f32, any size): 64 x 64 output tiles, one block of eight warps
//          per SM.  Four groups of 64 threads share each stage of 64 k
//          columns, group g taking 16 of them for the whole tile (an 8 x 8
//          register micro-tile a thread, A's rows and x read as float4 from
//          shared memory, conflict-free), so each SM has eight warps of FMAs
//          in flight.  A 4-stage ring is refilled a stage ahead: by TMA
//          where M, H % 4 == 0 and the pointers are aligned (A in two
//          64 x 32 halves with the 128-byte swizzle, x dense; one thread
//          issues, an mbarrier per stage counts the bytes), else by 4-byte
//          cp.async into the same layout: TMA keeps the copies off the
//          threads that compute, which 16-byte cp.async measured slower
//          than.  The groups' partial tiles are summed in the freed stages
//          before the cluster's reduction.  No TF32: the f32 checks rule it
//          out.
//   tc     (bf16, any size): 64 x 128 output tiles on tensor cores, two
//          blocks per SM.  A producer warpgroup fills a ring of 4 shared-
//          memory stages (A 64 x 64 k-major, X 64 x 128 n-major, both with
//          the 128-byte swizzle) with TMA, signalling mbarriers; a consumer
//          warpgroup runs wgmma m64n128k16 with f32 accumulators in
//          registers and frees a stage with one arrival per warp.  TMA
//          needs 16-byte strides (M, H % 8 == 0) and aligned pointers; where
//          both operands have them one producer thread does all the work
//          (fewer arrivals measured faster), otherwise the producers write
//          the same swizzled layout with 4-byte cp.async pairs (even
//          strides; the mbarrier counts their completion) or plain loads,
//          zero-filled past the edge.  TMA's out-of-bounds fill covers
//          ragged extents.
// Both tiled variants split k across the S blocks (S <= 8) of a thread-
// block cluster, one balanced slice of k-tiles each; the partial f32 tiles
// meet in distributed shared memory, each block summing its 1/S of the
// rows over the ranks (and the simt groups) in a fixed order
// (deterministic; no partial sum reaches device memory), and only then
// rounds and applies act.  simt pushes its rows to their owners (a
// relaxed cluster arrival at entry, waited on before the first push, so
// every block of the cluster has started; then one barrier); tc, whose
// wgmma fragments make scattered remote stores, pulls them (two barriers),
// which measured faster for each.  W is fused where F <= 16: each k-tile's
// xw = X[k-tile] @ W is formed in shared memory, a column (simt) or a
// column pair (tc) per thread with all its rows' chains in flight; the
// wrapper computes a wider x @ W as a plain product first.
//
// Each phase of the tiled variants can be compiled out for
// benchmarks_torch/adj_matmul_ablation.py: SKIP_LOADS, SKIP_MMA,
// SKIP_REDUCE (the cluster's reduction and the epilogue), SKIP_EPILOGUE.
#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using hk::launch_cluster;
using hk::tensor_map;

namespace {

using bf16 = __nv_bfloat16;

// ---- sizes, mirrored by adj_matmul_plan (adj_matmul.py) ----
constexpr int kSmallThreads = 512, kSmallCols = 32;
constexpr int kFm = 64, kFn = 64, kFk = 16, kFGroups = 4, kFStages = 4, kFStagesW = 3;
constexpr int kFKs = kFk * kFGroups;   // k columns per stage
constexpr int kFThreads = kFGroups * 64;   // each group: 64 threads of 8 x 8 outputs
static_assert(kFn == 64, "a group's thread per column of xw");
constexpr int kFRed = kFn + 4;         // row stride of the partial tiles
constexpr int kFMinSmem = 116 * 1024;  // more than half an SM's: one block per SM
constexpr int kFTile = kFm * kFKs;     // floats in one stage's A tile, and in its X tile
constexpr int kFHalf = kFm * 32;       // floats in one 32-column half of the A tile
constexpr int kTm = 64, kTn = 128, kTk = 64, kTStages = 4, kTStagesW = 3;
constexpr int kTConsumers = kTm / 64 * 128;         // one warpgroup per 64 rows
constexpr int kTThreads = kTConsumers + 128;        // and one producer warpgroup
constexpr int kMaxFusedF = 16, kMaxSplit = 8;
constexpr int kTABytes = kTm * kTk * 2;   // one stage's A tile (bf16)
constexpr int kTBBytes = kTk * kTn * 2;   // one stage's X tile, or X [kTk][F] with W (bf16)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the epilogue: the f32 sum rounded to T, then max(y, leak*y), rounded to T
template <typename T>
__device__ __forceinline__ T finish(float v, float leak, int has_leak) {
  float y = round_to<T>(v);
  if (has_leak) y = fmaxf(y, leak * y);
  return from_f<T>(y);
}

struct TileArgs {
  const void* a;
  const void* x;
  const void* w;
  void* out;
  int n, m, h, f;       // A [n,m], X [m,h] or [m,f] with W [f,h]
  int col_tiles;
  int k_bound[kMaxSplit + 1];   // cluster rank r sums k in [k_bound[r], k_bound[r+1])
  float leak;
  int has_leak;
  int pair_a, pair_x;   // tc without TMA: 4-byte cp.async pairs
};

// ---------------------------------------------------------------- small

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// Stage `count` contiguous elements into shared memory with 4-byte
// cp.async.  bf16 starts at the element whose address has the source's
// parity mod 4, so pairs travel as aligned 4-byte pieces and a lone first
// or last element is copied plainly.  `dst` is 16-byte aligned with two
// spare elements; returns where element 0 landed.
template <typename T>
__device__ const T* stage_flat(T* dst, const T* src, int count) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < count; i += kSmallThreads) hk::cp_async4(dst + i, src + i, true);
    return dst;
  } else {
    const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 1) & 1);
    T* d = dst + lead;
    const int pairs = count > lead ? (count - lead) / 2 : 0;
    for (int q = tid; q < pairs; q += kSmallThreads)
      hk::cp_async4(d + lead + 2 * q, src + lead + 2 * q, true);
    if (tid == 0 && count > 0) {
      if (lead) d[0] = src[0];
      if ((count - lead) & 1) d[count - 1] = src[count - 1];
    }
    return d;
  }
}

template <typename T, bool kW>
__global__ void __launch_bounds__(kSmallThreads)
adj_matmul_small_kernel(const T* __restrict__ a, const T* __restrict__ x,
                        const T* __restrict__ w, T* __restrict__ out, int n, int m, int h, int f,
                        int col_tiles, float leak, int has_leak) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / col_tiles;
  const int c0 = (blockIdx.x % col_tiles) * kSmallCols;
  const int hc = min(kSmallCols, h - c0);
  const int xcols = kW ? f : h;
  float* xw = reinterpret_cast<float*>(smem);   // [m][kSmallCols]
  T* base = reinterpret_cast<T*>(smem + m * kSmallCols * 4);
  const T* as = stage_flat(base, a + b * n * m, n * m);
  T* xbase = base + round8(n * m + 2);
  const T* xs = stage_flat(xbase, x + b * m * xcols, m * xcols);
  const T* ws = nullptr;
  if constexpr (kW) ws = stage_flat(xbase + round8(m * f + 2), w, f * h);
  hk::cp_async_commit();
  hk::cp_async_wait_all();
  __syncthreads();

  // one thread per (k, column) of xw, then per (row, column) of the output
  for (int e = tid; e < m * hc; e += kSmallThreads) {
    const int k = e / hc, c = e % hc;
    float v;
    if constexpr (kW) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};   // four chains over f overlap their latency
      int q = 0;
      for (; q + 4 <= f; q += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[u] = fmaf(to_f(xs[k * f + q + u]), to_f(ws[(q + u) * h + c0 + c]), s[u]);
      }
      for (; q < f; ++q) s[0] = fmaf(to_f(xs[k * f + q]), to_f(ws[q * h + c0 + c]), s[0]);
      v = round_to<T>((s[0] + s[1]) + (s[2] + s[3]));
    } else {
      v = to_f(xs[k * h + c0 + c]);
    }
    xw[k * kSmallCols + c] = v;
  }
  __syncthreads();

  T* ob = out + b * n * h;
  for (int e = tid; e < n * hc; e += kSmallThreads) {
    const int i = e / hc, c = e % hc;
    const T* ar = as + i * m;
    float s[4] = {0.f, 0.f, 0.f, 0.f};   // four chains over k overlap their latency
    int k = 0;
    for (; k + 4 <= m; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = fmaf(to_f(ar[k + u]), xw[(k + u) * kSmallCols + c], s[u]);
    }
    for (; k < m; ++k) s[0] = fmaf(to_f(ar[k]), xw[k * kSmallCols + c], s[0]);
    ob[static_cast<int64_t>(i) * h + c0 + c] =
        finish<T>((s[0] + s[1]) + (s[2] + s[3]), leak, has_leak);
  }
}

// -------------------------------------------------- the cluster reduction

// act of four sums, rounded to T, into o[0 .. min(4, left)): one 16-byte
// (f32) or 8-byte (bf16) store where all four fit and o is aligned for it
template <typename T>
__device__ __forceinline__ void store4(T* o, float4 s, int left, float leak, int has_leak) {
  struct alignas(4 * sizeof(T)) Four { T v[4]; };
  const Four q = {{finish<T>(s.x, leak, has_leak), finish<T>(s.y, leak, has_leak),
                   finish<T>(s.z, leak, has_leak), finish<T>(s.w, leak, has_leak)}};
  if (left >= 4 && reinterpret_cast<uintptr_t>(o) % sizeof(Four) == 0) {
    *reinterpret_cast<Four*>(o) = q;
  } else {
    for (int j = 0; j < 4 && j < left; ++j) o[j] = q.v[j];
  }
}

// The split-k reduction, pulled (tc).  The cluster's partial tiles summed in
// a fixed order, then act written to out (row-major [n, h], this tile at
// row0, col0).  Each block holds its partial tile [kRows][kCols] (f32, rows
// kStride apart) at `red` in its shared memory; each block sums its 1/S of
// the rows over the ranks in rank order, with every rank's read in flight
// at once, through ld.shared::cluster (which measured faster than generic
// loads of the mapped address).
template <typename T, int kRows, int kCols, int kStride, int kThreads>
__device__ void cluster_reduce_store(float* red, T* out, int row0, int col0, int n, int h,
                                     float leak, int has_leak) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#ifndef SKIP_REDUCE
  const int split = static_cast<int>(cluster.num_blocks());
  const int rows = kRows / split;
  const int r_begin = static_cast<int>(cluster.block_rank()) * rows;
  for (int e = threadIdx.x; e < rows * (kCols / 4); e += kThreads) {
    const int r = r_begin + e / (kCols / 4), c = (e % (kCols / 4)) * 4;
    float4 v[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < split) v[q] = hk::ld_cluster_f4(red + r * kStride + c, q);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < split) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
#ifndef SKIP_EPILOGUE
    const int gr = row0 + r;
    if (gr >= n) continue;
    store4(out + static_cast<int64_t>(gr) * h + col0 + c, s, h - col0 - c, leak, has_leak);
#else
    if (s.x == 12345.f) out[0] = from_f<T>(s.y);
#endif
  }
#endif
  cluster.sync();
}

// The split-k reduction, pushed (simt).  Of a tile of kRows rows, rank r of the S
// ranks of the cluster owns rows [r*R, (r+1)*R), R = kRows / S.  Each block
// stores its partial tile's rows into the owner's receive buffer
// (distributed shared memory), slot [its rank]; one cluster barrier later
// each owner sums its slots in rank order, the same order whatever the
// timing, so the result is deterministic; only then the sum is rounded and
// act applied.  No partial sum reaches device memory, and no block reads
// another's shared memory, so none waits at the end.  recv: kRows rows of
// kStride floats (kCols used) in every block, apart from the stages, since
// a faster rank pushes while this one computes.
template <int kRows, int kStride>
__device__ __forceinline__ float* push_row(cg::cluster_group& cluster, float* recv, int row) {
  const int split = static_cast<int>(cluster.num_blocks());
  const int rows = kRows / split;
  return cluster.map_shared_rank(recv, row / rows) +
         (static_cast<int>(cluster.block_rank()) * rows + row % rows) * kStride;
}

template <typename T, int kRows, int kCols, int kStride, int kThreads>
__device__ void cluster_sum_store(cg::cluster_group& cluster, const float* recv, T* out,
                                  int row0, int col0, int n, int h, float leak, int has_leak) {
  cluster.sync();   // every rank's pushes have landed
#ifndef SKIP_REDUCE
  const int split = static_cast<int>(cluster.num_blocks());
  const int rows = kRows / split;
  const int r_begin = static_cast<int>(cluster.block_rank()) * rows;
  for (int e = threadIdx.x; e < rows * (kCols / 4); e += kThreads) {
    const int r = e / (kCols / 4), c = (e % (kCols / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int slot = 0; slot < split; ++slot) {
      const float4 v = *reinterpret_cast<const float4*>(recv + (slot * rows + r) * kStride + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
#ifndef SKIP_EPILOGUE
    const int gr = row0 + r_begin + r;
    if (gr >= n) continue;
    store4(out + static_cast<int64_t>(gr) * h + col0 + c, s, h - col0 - c, leak, has_leak);
#else
    if (s.x == 12345.f) out[0] = from_f<T>(s.y);
#endif
  }
#endif
}

// ------------------------------------------------------------ simt (f32)

// Float offset of A[r][k] (r, k < 64) in a stage: two 64 x 32 halves along
// k, each in TMA's 128-byte swizzle (the 16-byte chunk c of row r at
// c ^ (r & 7)), so the float4 reads of rows ty + 8i are free of bank
// conflicts.
__device__ __forceinline__ int a_off(int r, int k) {
  return (k >> 5) * kFHalf + r * 32 + ((((k & 31) >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// One block per SM: kFGroups groups of 64 threads share each stage of
// kFKs = kFGroups * kFk columns of k, group g taking columns [g*kFk, (g+1)*kFk)
// for the whole kFm x kFn tile; thread (ty, tx) of a group owns rows
// ty + 8*i and columns tx*4 + [0,4) and kFn/2 + tx*4 + [0,4), and reads A
// (swizzled, float4 along k) and x (rows of kFn, float4) free of bank
// conflicts.  Thread 0 loads A and x with TMA where the strides allow
// (tma_a, tma_x), signalling the stage's mbarrier; otherwise every thread
// copies 4-byte pieces into the same layout with cp.async.
template <bool kW>
__global__ void __launch_bounds__(kFThreads, 1)
adj_matmul_simt_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ TileArgs p, int tma_a, int tma_x) {
  // the partial tiles go into other blocks' shared memory: they must have
  // started, which the wait before the first push makes sure of
  hk::cluster_arrive_relaxed();
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned
  unsigned char* smem = smem_raw + ((1024 - (hk::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStages = kW ? kFStagesW : kFStages;
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + kStages * kFTile;   // x [kFKs][kFn], or x [kFKs][f] with W
  float* ws = bs + kStages * kFTile;   // W [f][kFn] (W only)
  float* bx = ws + p.f * kFn;          // xw [kFKs][kFn] (W only)
  float* recv = kW ? bx + kFTile : ws;   // [kFm][kFRed]: the ranks' rows of this block's share
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + kFm * kFRed);
  const int tid = threadIdx.x;
  const int g = tid / 64, lt = tid % 64, ty = lt / 8, tx = lt % 8;
  const int rank = blockIdx.x;
  const int row0 = (blockIdx.y / p.col_tiles) * kFm, col0 = (blockIdx.y % p.col_tiles) * kFn;
  const int64_t b = blockIdx.z;
  const int n = p.n, m = p.m, h = p.h, f = p.f;
  const float* ab = static_cast<const float*>(p.a) + b * n * m;
  const float* xb = static_cast<const float*>(p.x) + b * m * (kW ? f : h);
  const int kt0 = p.k_bound[rank] / kFKs;
  const int nk = (p.k_bound[rank + 1] + kFKs - 1) / kFKs - kt0;
  const bool x_by_tma = !kW && tma_x, any_tma = tma_a || x_by_tma;

  if (tid == 0 && any_tma) {
    for (int s = 0; s < kStages; ++s) hk::mbar_init(full + s, 1);   // thread 0 and the TMA
    hk::mbar_init_fence();
  }
  if constexpr (kW) {   // W's column slice, zero past h; rides in the first group
    const float* wg = static_cast<const float*>(p.w);
    for (int e = tid; e < f * kFn; e += kFThreads) {
      const int q = e / kFn, c = e % kFn;
      const bool ok = col0 + c < h;
      hk::cp_async4(ws + e, wg + (ok ? static_cast<int64_t>(q) * h + col0 + c : 0), ok);
    }
  }
  __syncthreads();

  auto load = [&](int t, int s) {   // k-tile t into stage s
#ifndef SKIP_LOADS
    const int k0 = t * kFKs;
    float* a_s = as + s * kFTile;
    float* b_s = bs + s * kFTile;
    if (tid == 0 && any_tma) {   // the TMA zero-fills past the edges
      hk::fence_proxy_async();   // after every thread's reads of the stage (the barrier)
      hk::mbar_arrive_expect_tx(full + s, (tma_a ? kFTile * 4 : 0) + (x_by_tma ? kFTile * 4 : 0));
      if (tma_a) {
        hk::tma_load_3d(a_s, &map_a, full + s, k0, row0, static_cast<int>(b));
        hk::tma_load_3d(a_s + kFHalf, &map_a, full + s, k0 + 32, row0, static_cast<int>(b));
      }
      if (x_by_tma) hk::tma_load_3d(b_s, &map_x, full + s, col0, k0, static_cast<int>(b));
    }
    if (!tma_a) {
      for (int e = tid; e < kFm * kFKs; e += kFThreads) {
        const int r = e / kFKs, kk = e % kFKs;
        const bool ok = row0 + r < n && k0 + kk < m;
        hk::cp_async4(a_s + a_off(r, kk),
                      ab + (ok ? static_cast<int64_t>(row0 + r) * m + k0 + kk : 0), ok);
      }
    }
    if constexpr (kW) {
      for (int e = tid; e < kFKs * f; e += kFThreads) {
        const int kk = e / f, q = e % f;
        const bool ok = k0 + kk < m;
        hk::cp_async4(b_s + e, xb + (ok ? static_cast<int64_t>(k0 + kk) * f + q : 0), ok);
      }
    } else if (!tma_x) {
      for (int e = tid; e < kFKs * kFn; e += kFThreads) {
        const int kk = e / kFn, c = e % kFn;
        const bool ok = k0 + kk < m && col0 + c < h;
        hk::cp_async4(b_s + e, xb + (ok ? static_cast<int64_t>(k0 + kk) * h + col0 + c : 0),
                      ok);
      }
    }
#endif
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(kt0 + s, s);
    hk::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    hk::cp_async_wait<kStages - 2>();
#ifndef SKIP_LOADS
    if (any_tma) hk::mbar_wait(full + s, (it / kStages) & 1);
#endif
    __syncthreads();
    // refill the stage every thread finished with last iteration
    const int nt = it + kStages - 1;
    if (nt < nk) load(kt0 + nt, nt % kStages);
    hk::cp_async_commit();
    const float* a_s = as + s * kFTile;
    const float* b_s = bs + s * kFTile + g * kFk * kFn;   // this group's k rows of x
    if constexpr (kW) {   // this group's xw = x[k columns] @ W (f32: no rounding)
      const float* x_s = bs + s * kFTile + g * kFk * f;
      float* bxg = bx + g * kFk * kFn;
      // thread lt owns column lt for all kFk rows: kFk chains in flight
      float v[kFk];
#pragma unroll
      for (int kk = 0; kk < kFk; ++kk) v[kk] = 0.f;
      for (int q = 0; q < f; ++q) {
        const float wq = ws[q * kFn + lt];
#pragma unroll
        for (int kk = 0; kk < kFk; ++kk) v[kk] = fmaf(x_s[kk * f + q], wq, v[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < kFk; ++kk) bxg[kk * kFn + lt] = v[kk];
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + g) : "memory");
      b_s = bxg;
    }
#ifndef SKIP_MMA
#pragma unroll
    for (int kq = 0; kq < kFk; kq += 4) {   // four k at a time: A's rows as float4
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a_s + a_off(ty + 8 * i, g * kFk + kq));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + (kq + u) * kFn + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b_s + (kq + u) * kFn + kFn / 2 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
#endif
  }
  hk::cp_async_wait_all();

  // the groups' partial tiles meet in the freed stages and are summed in
  // group order; each sum is pushed to the rank that owns its row
  __syncthreads();
  float* part = as;   // [kFGroups][kFm][kFRed]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + (g * kFm + ty + 8 * i) * kFRed;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + kFn / 2 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  hk::cluster_wait();
  for (int e = tid; e < kFm * kFn / 4; e += kFThreads) {
    const int r = e / (kFn / 4), c = (e % (kFn / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kFGroups; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(part + (q * kFm + r) * kFRed + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
#ifndef SKIP_REDUCE
    float* row = push_row<kFm, kFRed>(cluster, recv, r);
#else   // kept local: the products stay, the exchange goes
    float* row = recv + r * kFRed;
#endif
    *reinterpret_cast<float4*>(row + c) = sum;
  }
  cluster_sum_store<float, kFm, kFn, kFRed, kFThreads>(
      cluster, recv, static_cast<float*>(p.out) + b * n * h, row0, col0, n, h, p.leak,
      p.has_leak);
}

// ------------------------------------------------------------- tc (bf16)

// byte offset of element (r, k) in a 128-byte-swizzled k-major tile with
// rows of 64 bf16 (A), and of element (k, c) in an n-major tile of two
// 64-wide atoms of kTk rows (X): TMA's SWIZZLE_128B layout
__device__ __forceinline__ int kmajor_off(int r, int k) {
  return r * 128 + ((((k >> 3) ^ (r & 7))) << 4) + (k & 7) * 2;
}
__device__ __forceinline__ int nmajor_off(int k, int c) {
  return (c >> 6) * (kTBBytes / 2) + k * 128 + (((((c & 63) >> 3) ^ (k & 7))) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void store_pair(unsigned char* d, bf16 v0, bf16 v1) {
  __nv_bfloat162 v;
  v.x = v0;
  v.y = v1;
  *reinterpret_cast<__nv_bfloat162*>(d) = v;
}

// A[b, row0.., k0..] into the stage without TMA, zero past the edge
__device__ void load_a_manual(unsigned char* a_s, const bf16* ab, const TileArgs& p, int row0,
                              int k0, int pt) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = pt; e < kTm * kTk / 2; e += 128) {
    const int r = e / (kTk / 2), kk = (e % (kTk / 2)) * 2;
    const int gr = row0 + r, gk = k0 + kk;
    unsigned char* d = a_s + kmajor_off(r, kk);
    const int64_t at = static_cast<int64_t>(gr) * p.m + gk;
    if (p.pair_a) {
      const bool ok = gr < p.n && gk < p.m;
      hk::cp_async4(d, ab + (ok ? at : 0), ok);
    } else {
      store_pair(d, gr < p.n && gk < p.m ? ab[at] : zero,
                 gr < p.n && gk + 1 < p.m ? ab[at + 1] : zero);
    }
  }
}

// X[b, k0.., col0..] into the stage without TMA, zero past the last row;
// the columns past h stay as zero_x_stages left them
__device__ void load_x_manual(unsigned char* b_s, const bf16* xb, const TileArgs& p, int col0,
                              int k0, int pt) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = pt; e < kTk * kTn / 2; e += 128) {
    const int kk = e / (kTn / 2), c = (e % (kTn / 2)) * 2;
    if (c >= p.h - col0) continue;
    const int gk = k0 + kk, gc = col0 + c;
    unsigned char* d = b_s + nmajor_off(kk, c);
    const int64_t at = static_cast<int64_t>(gk) * p.h + gc;
    if (p.pair_x) {
      const bool ok = gk < p.m && gc < p.h;
      hk::cp_async4(d, xb + (ok ? at : 0), ok);
    } else {
      store_pair(d, gk < p.m && gc < p.h ? xb[at] : zero,
                 gk < p.m && gc + 1 < p.h ? xb[at + 1] : zero);
    }
  }
}

template <bool kW>
__global__ void __launch_bounds__(kTThreads, 2)   // two blocks per SM
adj_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ TileArgs p, int tma_a, int tma_x) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned
  unsigned char* smem = smem_raw + ((1024 - (hk::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStages = kW ? kTStagesW : kTStages;
  constexpr int kStageBytes = kTABytes + kTBBytes;
  unsigned char* xw_tile = smem + kStages * kStageBytes;             // W only
  float* ws = reinterpret_cast<float*>(xw_tile + kTBBytes);          // W only: [f][kTn]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStageBytes + (kW ? kTBBytes + p.f * kTn * 4 : 0));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int row0 = (blockIdx.y / p.col_tiles) * kTm, col0 = (blockIdx.y % p.col_tiles) * kTn;
  const int b = blockIdx.z;
  const int n = p.n, m = p.m, h = p.h, f = p.f;
  const bf16* ab = static_cast<const bf16*>(p.a) + static_cast<int64_t>(b) * n * m;
  const bf16* xb = static_cast<const bf16*>(p.x) + static_cast<int64_t>(b) * m * (kW ? f : h);
  const int kt0 = p.k_bound[rank] / kTk;
  const int nk = (p.k_bound[rank + 1] + kTk - 1) / kTk - kt0;
  const bool x_by_tma = !kW && tma_x;
  // every copy a producer thread makes is a cp.async (or TMA): it need not wait
  const bool async_only = !kW && (tma_a || p.pair_a) && (x_by_tma || p.pair_x);
  // both operands by TMA: the first producer thread alone fills the ring
  const bool tma_only = tma_a && x_by_tma;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // every producer thread and the TMA, or the TMA alone
      hk::mbar_init(full + s, tma_only ? 1 : 128 + (tma_a || x_by_tma));
      hk::mbar_init(empty + s, kTConsumers / 32);   // each consumer warp arrives
    }
    hk::mbar_init_fence();
  }
  if constexpr (kW) {   // W's column slice in f32, zero past h
    const bf16* wg = static_cast<const bf16*>(p.w);
    for (int e = tid; e < f * kTn; e += kTThreads) {
      const int q = e / kTn, c = e % kTn;
      ws[e] = col0 + c < h ? to_f(wg[static_cast<int64_t>(q) * h + col0 + c]) : 0.f;
    }
  } else if (!tma_x && col0 + kTn > h) {   // X's columns past h, zero in every stage for good
    for (int e = tid; e < kStages * kTBBytes / 16; e += kTThreads)
      reinterpret_cast<uint4*>(smem + (e / (kTBBytes / 16)) * kStageBytes + kTABytes)
          [e % (kTBBytes / 16)] = make_uint4(0, 0, 0, 0);
    hk::fence_proxy_async();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (tid >= kTConsumers) {   // producer warpgroup
    const int pt = tid - kTConsumers;
    for (int it = 0; it < nk && (pt == 0 || !tma_only); ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      hk::mbar_wait(empty + s, ph ^ 1);
      const int k0 = (kt0 + it) * kTk;
      unsigned char* a_s = smem + s * kStageBytes;
      unsigned char* b_s = a_s + kTABytes;
#ifndef SKIP_LOADS
      if (!tma_only) {
      if (!tma_a) load_a_manual(a_s, ab, p, row0, k0, pt);
      bool stored = !async_only;   // plain stores to the stage
      if constexpr (kW) {
        // X's rows k0.. are one run of count elements: 4-byte copies of
        // pairs from the element whose address has the run's parity mod 4
        // (the stage keeps one spare element); a lone first or last
        // element, and the rows past m, as plain stores
        const bf16* src = xb + static_cast<int64_t>(k0) * f;
        const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 1) & 1);
        bf16* dst = reinterpret_cast<bf16*>(b_s) + lead;
        const int count = min(kTk, m - k0) * f;
        const int pairs = (count - lead) / 2;
        for (int q = pt; q < pairs; q += 128)
          hk::cp_async4(dst + lead + 2 * q, src + lead + 2 * q, true);
        if (pt == 0 && lead) dst[0] = src[0];
        if (pt == 0 && ((count - lead) & 1)) dst[count - 1] = src[count - 1];
        for (int e = count + pt; e < kTk * f; e += 128) dst[e] = __float2bfloat16(0.f);
        stored = !(tma_a || p.pair_a) || (pt == 0 && (lead || ((count - lead) & 1))) ||
                 count + pt < kTk * f;
      } else if (!tma_x) {
        load_x_manual(b_s, xb, p, col0, k0, pt);
      }
      if (!stored) {   // arrives once this thread's copies land
        hk::mbar_cp_async_arrive(full + s);
      } else {            // plain stores: wait, make them visible to wgmma, arrive
        hk::cp_async_wait_all();
        hk::fence_proxy_async();
        hk::mbar_arrive(full + s);
      }
      }
      if (pt == 0 && (tma_a || x_by_tma)) {
        hk::mbar_arrive_expect_tx(full + s, (tma_a ? kTABytes : 0) + (x_by_tma ? kTBBytes : 0));
        if (tma_a) hk::tma_load_3d(a_s, &map_a, full + s, k0, row0, b);
        if (x_by_tma) {
          hk::tma_load_3d(b_s, &map_x, full + s, col0, k0, b);
          hk::tma_load_3d(b_s + kTBBytes / 2, &map_x, full + s, col0 + 64, k0, b);
        }
      }
#else
      if (!tma_only) hk::mbar_arrive(full + s);
      if (pt == 0 && (tma_a || x_by_tma)) hk::mbar_arrive(full + s);
#endif
    }
  } else {   // consumer warpgroups, 64 rows of the tile each
    const int wg = tid / 128;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      hk::mbar_wait(full + s, ph);
      unsigned char* a_s = smem + s * kStageBytes;
      const unsigned char* b_s = a_s + kTABytes;
      if constexpr (kW) {
        // xw = round_bf16(X[k-tile] @ W) into the n-major swizzled layout;
        // the other warpgroup may still read the previous tile
        asm volatile("bar.sync 1, %0;\n" ::"n"(kTConsumers) : "memory");
        const bf16* src = xb + static_cast<int64_t>(kt0 + it) * kTk * f;   // as the producer
        const bf16* x_s = reinterpret_cast<const bf16*>(b_s) +
                          static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 1) & 1);
        // thread t owns columns c, c+1 and rows t / (kTn/2) + kStep * j: 16 rows
        // (32 chains) in flight at a time
        constexpr int kStep = kTConsumers / (kTn / 2);
        const int c = (tid % (kTn / 2)) * 2, kk0 = tid / (kTn / 2);
        for (int j0 = 0; j0 < kTk / kStep; j0 += 16) {
          float s0[16], s1[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) s0[j] = s1[j] = 0.f;
          for (int q = 0; q < f; ++q) {
            const float w0 = ws[q * kTn + c], w1 = ws[q * kTn + c + 1];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float xv = to_f(x_s[(kk0 + kStep * (j0 + j)) * f + q]);
              s0[j] = fmaf(xv, w0, s0[j]);
              s1[j] = fmaf(xv, w1, s1[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
            store_pair(xw_tile + nmajor_off(kk0 + kStep * (j0 + j), c), __float2bfloat16(s0[j]),
                       __float2bfloat16(s1[j]));
        }
        hk::fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(kTConsumers) : "memory");
        b_s = xw_tile;
      } else if (!tma_a || !tma_x) {
        hk::fence_proxy_async();
      }
#ifndef SKIP_MMA
      hk::fence_regs(acc);
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTk / 16; ++kk) {
        const uint64_t da = hk::gmma_desc(a_s + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = hk::gmma_desc(b_s + kk * 16 * 128, kTBBytes / 2, 1024);
        hk::wgmma_m64n128k16_bf16(acc, da, db);
      }
      hk::wgmma_commit();
      hk::wgmma_wait_all();
      hk::fence_regs(acc);
#endif
      __syncwarp();   // the warp's reads of the stage are done
      if (tid % 32 == 0) hk::mbar_arrive(empty + s);
    }
  }
  __syncthreads();

  // [kTm][kTn] with rows kTn + 8 apart (the accumulator layout's stores hit
  // 8 rows at once), over the stages
  constexpr int kRed = kTn + 8;
  float* red = reinterpret_cast<float*>(smem);
  if (tid < kTConsumers) {   // wgmma's accumulator layout: warp w of the warpgroup owns 16 rows
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int r = (tid / 128) * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kTn / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(red + r * kRed + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(red + (r + 8) * kRed + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  cluster_reduce_store<bf16, kTm, kTn, kRed, kTThreads>(
      red, static_cast<bf16*>(p.out) + static_cast<int64_t>(b) * n * h, row0, col0, n, h,
      p.leak, p.has_leak);
}

// ------------------------------------------------------------------ host

// dynamic shared memory of the tiled kernels: simt's stages (and W's) and
// receive buffer, at least kFMinSmem (one block per SM); tc's 1024-byte
// alignment slack, stages (and W's) and mbarriers
size_t simt_smem(bool w, int f) {
  const int stages = w ? kFStagesW : kFStages;
  return std::max<size_t>(
      1024 + 4 * (static_cast<size_t>(stages) * 2 * kFTile +
                  (w ? static_cast<size_t>(f) * kFn + kFTile : 0) +
                  static_cast<size_t>(kFm) * kFRed) + 8 * stages,
      kFMinSmem);
}
size_t tc_smem(bool w, int f) {
  const int stages = w ? kTStagesW : kTStages;
  return 1024 + static_cast<size_t>(stages) * (kTABytes + kTBBytes) +
         (w ? kTBBytes + static_cast<size_t>(f) * kTn * 4 : 0) + 2 * stages * 8;
}

// the dynamic shared memory of the small variant: xw in f32, and A, X and
// W staged (two spare elements each)
template <typename T>
size_t small_smem(int n, int m, int h, int f, bool w) {
  return static_cast<size_t>(m) * kSmallCols * 4 +
         sizeof(T) * (round8(n * m + 2) + round8(m * (w ? f : h) + 2) + (w ? round8(f * h + 2) : 0));
}

}  // namespace

// What adj_matmul_plan (adj_matmul.py) picked, as adj_matmul_launch takes
// it: the launch checks it against the kernels' sizes above and launches it
// as it stands, so the plan the CPU tests hold is the one that runs.
struct LaunchPlan {
  int variant;                  // 0 = small, 1 = simt (f32), 2 = tc (bf16)
  int split;                    // the k-split, which is the cluster size
  int grid[3];
  int threads, smem, stages;
  int tile[3];                  // output rows, columns, and the k step
  int k_bound[kMaxSplit + 1];   // rank r takes k in [k_bound[r], k_bound[r+1])
  int tma_a, tma_x;             // tiled variants: A / x by TMA
};

namespace {

bool same3(const int (&v)[3], int64_t x, int64_t y, int64_t z) {
  return v[0] == x && v[1] == y && v[2] == z;
}

// the k-slices cover [0, m) once, in rank order, split on k-step boundaries;
// when k is split, none is empty (a split larger than the k-tiles is refused)
bool k_slices_ok(const LaunchPlan& lp, int m, int k_step) {
  if (lp.k_bound[0] != 0 || lp.k_bound[lp.split] != m) return false;
  for (int r = 0; r < lp.split; ++r) {
    const int lo = lp.k_bound[r], hi = lp.k_bound[r + 1];
    if (hi < lo || (lp.split > 1 && hi == lo) || lo % k_step != 0) return false;
  }
  return true;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T>
int launch_small(const void* a, const void* x, const void* w, void* out, int batch, int n,
                 int m, int h, int f, float leak, int has_leak, const LaunchPlan& lp,
                 cudaStream_t stream) {
  const int col_tiles = (h + kSmallCols - 1) / kSmallCols;
  const size_t smem = small_smem<T>(n, m, h, f, w != nullptr);
  if (smem > 48 * 1024 || lp.smem != static_cast<int>(smem) || lp.threads != kSmallThreads ||
      lp.stages != 1 || lp.split != 1 || !same3(lp.tile, n, kSmallCols, m) ||
      !same3(lp.grid, static_cast<int64_t>(batch) * col_tiles, 1, 1) || !k_slices_ok(lp, m, 1) ||
      lp.tma_a || lp.tma_x)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* ta = static_cast<const T*>(a);
  const T* tx = static_cast<const T*>(x);
  const T* tw = static_cast<const T*>(w);
  T* to = static_cast<T*>(out);
  if (w)
    adj_matmul_small_kernel<T, true><<<lp.grid[0], lp.threads, lp.smem, stream>>>(
        ta, tx, tw, to, n, m, h, f, col_tiles, leak, has_leak);
  else
    adj_matmul_small_kernel<T, false><<<lp.grid[0], lp.threads, lp.smem, stream>>>(
        ta, tx, tw, to, n, m, h, f, col_tiles, leak, has_leak);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of what adj_matmul_plan picked (`plan`).  a [batch,n,m], x
// [batch,m,h] (or [batch,m,f] with w [f,h]) and out [batch,n,h] are
// contiguous; w may be null.  dtype: 0 = float32, 1 = bfloat16.  A plan
// that does not match the kernels' sizes or the operands is refused with
// cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int adj_matmul_launch(const void* a, const void* x, const void* w, void* out,
                                 int batch, int n, int m, int h, int f, float leak,
                                 int has_leak, int dtype, const LaunchPlan* plan, void* stream) {
  if (batch == 0 || n == 0 || h == 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || !plan) return bad;
  const LaunchPlan& lp = *plan;
  if (lp.split < 1 || lp.split > kMaxSplit || (lp.split & (lp.split - 1))) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lp.variant == 0)
    return dtype == 0
               ? launch_small<float>(a, x, w, out, batch, n, m, h, f, leak, has_leak, lp, st)
               : launch_small<bf16>(a, x, w, out, batch, n, m, h, f, leak, has_leak, lp, st);

  const bool simt = dtype == 0, fused = w != nullptr;
  if (lp.variant != 1 + dtype || batch > 65535 || (fused && (f < 1 || f > kMaxFusedF)))
    return bad;
  const int tm = simt ? kFm : kTm, tn = simt ? kFn : kTn, tk = simt ? kFKs : kTk;
  const int stages = simt ? (fused ? kFStagesW : kFStages) : (fused ? kTStagesW : kTStages);
  const size_t smem = simt ? simt_smem(fused, f) : tc_smem(fused, f);
  const int col_tiles = (h + tn - 1) / tn;
  const int64_t tiles = static_cast<int64_t>((n + tm - 1) / tm) * col_tiles;
  // TMA needs 16-byte rows and an aligned start
  const bool tma_ok_a = m > 0 && m % (simt ? 4 : 8) == 0 && aligned16(a);
  const bool tma_ok_x = m > 0 && !fused && h % (simt ? 4 : 8) == 0 && aligned16(x);
  if (tiles > 65535 || !same3(lp.tile, tm, tn, tk) ||
      lp.threads != (simt ? kFThreads : kTThreads) || lp.stages != stages ||
      lp.smem != static_cast<int>(smem) || !same3(lp.grid, lp.split, tiles, batch) ||
      !k_slices_ok(lp, m, tk) || (lp.tma_a && !tma_ok_a) || (lp.tma_x && !tma_ok_x))
    return bad;

  TileArgs p{a, x, w, out, n, m, h, fused ? f : 0, col_tiles, {}, leak, has_leak, 0, 0};
  std::copy(lp.k_bound, lp.k_bound + lp.split + 1, p.k_bound);
  const dim3 grid(lp.grid[0], lp.grid[1], lp.grid[2]);
  CUtensorMap map_a = {}, map_x = {};
  if (simt) {   // A in 64 x 32 halves with the 128-byte swizzle; x in 64 x 64 rows
    if (lp.tma_a && !tensor_map(&map_a, a, 0, m, n, batch, 32, kFm, CU_TENSOR_MAP_SWIZZLE_128B))
      return bad;
    if (lp.tma_x && !tensor_map(&map_x, x, 0, h, m, batch, kFn, kFKs, CU_TENSOR_MAP_SWIZZLE_NONE))
      return bad;
    return fused ? launch_cluster(adj_matmul_simt_kernel<true>, grid, lp.threads, lp.smem,
                                  lp.split, st, map_a, map_x, p, lp.tma_a, 0)
                 : launch_cluster(adj_matmul_simt_kernel<false>, grid, lp.threads, lp.smem,
                                  lp.split, st, map_a, map_x, p, lp.tma_a, lp.tma_x);
  }
  p.pair_a = m % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  p.pair_x = h % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  if (lp.tma_a && !tensor_map(&map_a, a, 1, m, n, batch, kTk, kTm, CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  if (lp.tma_x && !tensor_map(&map_x, x, 1, h, m, batch, 64, kTk, CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  return fused ? launch_cluster(adj_matmul_tc_kernel<true>, grid, lp.threads, lp.smem, lp.split,
                                st, map_a, map_x, p, lp.tma_a, 0)
               : launch_cluster(adj_matmul_tc_kernel<false>, grid, lp.threads, lp.smem, lp.split,
                                st, map_a, map_x, p, lp.tma_a, lp.tma_x);
}

// How many clusters of `split` blocks of the tiled kernel for `dtype`
// (without W) the card holds at once, from cudaOccupancyMaxActiveClusters:
// the figures adj_matmul_plan's MAX_CLUSTERS table holds.
extern "C" int adj_matmul_max_clusters(int dtype, int split, int* clusters) {
  return dtype == 0 ? hk::max_clusters(adj_matmul_simt_kernel<false>, kFThreads,
                                       simt_smem(false, 0), split, clusters)
                    : hk::max_clusters(adj_matmul_tc_kernel<false>, kTThreads, tc_smem(false, 0),
                                       split, clusters);
}
