// adj_matmul_backward: the gradient of adj_matmul (csrc/adj_matmul.cu),
// out = act(y), y = round_T(A @ xw), xw = X (no W) or round_T(X @ W), act
// the identity or max(y, leak*y), for f32 or bf16 tensors.  With g =
// dL/dout:
//
//   gy  = g * s,  s = 1 (out > 0), leak (out < 0 or -0.0), (1 + leak)/2 (out == +0.0)
//   gxw = round_T(A^T @ gy)                      [B,m,h]
//   gx  = round_T(gxw @ W^T)     (gx = gxw without W)
//   gW  = round_T(sum_b X_b^T @ gxw_b)
//   gA  = round_T(gy @ xw^T)     (xw recomputed, rounded to T)
//
// every sum in f32.  These are the roundings of autograd through the plain
// version (adj_matmul.py, adj_matmul_plain): torch.maximum's backward splits
// the gradient at a tie, g/2 to each side, so y == 0 (a row of A that is
// all zero, or x = 0) takes g/2 + round(leak * g/2); in bf16 each of those
// steps rounds to bf16, and so does leak * g where y < 0.  y's sign is read
// from the forward's output (leak > 0 keeps it): an output of -0.0 is taken
// as y < 0 with leak*y underflowing, which is what it is wherever y comes
// from an f32 sum started at +0, as in the forward kernel; only a y of
// exactly -0.0 (a bf16 rounding of a negative sum below 2^-134) would have
// taken the tie's factor instead.
//
// The TPU kernel it stands beside, blocked_adj_matmul (snd_vae_tpu/nn/
// pallas/blocked_spmm.py:89, pallas_call :126), has no backward: pallas_call
// has no transpose rule, and JAX's GraphConv (snd_vae_tpu/nn/graph_conv.py:
// 29-45) is two einsums that XLA differentiates.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 on CUDA cores, 989
// bf16 on tensor cores):
//   * the served GraphConvs, [10,25,25] with F,H = 1,10 and 11,20: ~20-60 KB
//     and ~0.1 MFLOP, ~0.02 us: the launch and the chain of dependent
//     shared-memory phases bound it, so one launch does all of it;
//   * [8192,8192] @ [8192,128]: A^T @ gy is 17.2 GFLOP, 256 us of f32
//     operations on CUDA cores; in bf16 on tensor cores 17 us of operations
//     against 40 us of bytes (A, 134 MB): bytes bound it.  [2048,2048] @
//     [2048,128]: f32 16 us of operations, bf16 ~3 us of bytes.
//   * gxw is tall and thin: at N = 2048 there are 32 (f32) or 16 (bf16) row
//     tiles of it for 132 SMs, so the sum over i is split across the blocks
//     of a thread-block cluster to fill the card.
//
// Design: the central product is the forward's (csrc/adj_matmul.cu) with A
// transposed and an elementwise pass on the B operand, so the tiled
// variants are built from the forward's parts (csrc/hopper.cuh).
// adj_matmul_backward_plan (adj_matmul.py) picks a variant and its sizes
// from the shapes alone, and the launch below checks what it picked
// against the sizes here:
//   small  (n, m <= 64 and the graph's operands fit 48 KB: the model's
//          path, synthetic2 [10,25,25], protein [50,50,50], mnist
//          [2,50,50]): one block per graph stages A (rows padded to an odd
//          stride), gy (formed from g and out as it is staged), X and W in
//          shared memory as f32, forms gxw in shared memory (one thread per
//          (k, column), four chains over i, reading A down its columns),
//          then gx (per (k, f)) and the graph's partial gW (per (f,
//          column)) from it.  W is always fused.
//   simt   (f32, any larger size): 64 x 64 gxw tiles (rows k, columns h) on
//          CUDA cores, one block of eight warps per SM, the forward simt's
//          layout: four groups of 64 threads split each stage's 64 i-rows,
//          16 each, for the whole tile, an 8 x 8 register micro-tile a
//          thread (k rows 4ty.. and 32 + 4ty.., columns 4tx.. and 32 +
//          4tx..).  A's box [i][k] lands with the k a thread owns
//          contiguous, so A^T needs no transpose: both operands are read as
//          float4 rows, conflict-free.  A ring of 4 stages (A, g, out: 64 x
//          64 each) is refilled a stage ahead by TMA (3-D maps, one thread
//          issues, an mbarrier per stage counts the bytes) where the
//          strides are 16-byte multiples and the pointers aligned, else by
//          4-byte cp.async into the same dense layout.  Each group forms
//          gy (grad_y, with out) for its rows into a gy tile before it
//          consumes them, four values at a time.  No TF32: the f32 checks
//          rule it out.
//   tc     (bf16, any larger size): 128 x 128 gxw tiles on tensor cores,
//          the forward tc's warp roles: a producer warpgroup keeps TMA
//          loads of A, g and out in flight (a ring of 4 stages of 64
//          i-rows; 4-byte cp.async pairs or plain loads into the same
//          layout where TMA's strides fail), two consumer warpgroups (64
//          k-rows each) run wgmma m64n128k16 with f32 accumulators.  A^T is
//          wgmma's MN-major A operand (A's box [i][k] with the 128-byte
//          swizzle, the transpose bit set); g and out land in the MN-major B
//          layout, and the consumers turn step j + 1's g into gy in place
//          while the tensor cores run step j (bf16-exact: grad_y rounds
//          each factor to bf16; 16 bytes at a time, out's sign by packed
//          compares, a pair's products rounded by one conversion), fence
//          the writes to the async proxy and run the MMA on it.
// Every block forms gy afresh for its slice of i, so the gxw row tiles
// repeat that pass: with act it is the tiled variants' largest phase.
// Both tiled variants split the sum over i across the S blocks (S <= 8) of
// a cluster, balanced slices of whole i-steps; the partial f32 tiles stay
// in shared memory and each rank sums its 1/S of the rows over the ranks in
// rank order through distributed shared memory (pulled), so the result is
// deterministic and no partial tile reaches device memory.  Then the
// rank's rows are rounded to T: gxw goes to gx where there is no W (or gxw
// where the wrapper forms a wide F's products); where W is fused (F <=
// 16 and h one column tile) the epilogue forms gx = gxw W^T for the rows
// and the rows' partial gW = X^T gxw.  Offsets are 64-bit.
// The partial gW (one per graph, or per block) go to an f32 workspace;
// every block then takes one atomic increment of a counter, and the block
// that takes the last one sums the partials in a fixed order, writes gW and
// resets the counter to 0 for the next launch on its stream.  Only the
// election is atomic; every float sum has a fixed order, so two calls are
// bit-equal.
//   dA     (a second launch, only when dL/dA is asked; no path asks today):
//          64 x 64 tiles of gA (rows i, columns k), h in steps of 32, gy
//          and xw staged transposed (xw = round_T(X @ W) recomputed in
//          shared memory where W is fused).
//
// Each phase can be compiled out for benchmarks_torch/adj_matmul_ablation.py:
// SKIP_LOADS (the stages' copies), SKIP_GY (the gy pass), SKIP_MMA (the
// products), SKIP_REDUCE (the cluster's exchange: each rank keeps its own
// partial), SKIP_ELECTION (the atomic election and the last block's sum of
// gW) and SKIP_LAST_SUM (the last block's sum alone).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// ---- sizes, mirrored by adj_matmul_backward_plan (adj_matmul.py) ----
constexpr int kThreads = 256;                 // small and dA
constexpr int kSmallMax = 64, kSmallMaxSmem = 48 * 1024;
constexpr int kDi = 64, kDk = 64, kDh = 32;   // dA: tile rows i, columns k; h step
constexpr int kDs = 64 + 4;                   // row stride of dA's transposed operands
constexpr int kMaxFusedF = 16, kMaxSplit = 8, kStages = 4;
// simt: gxw tile rows k, columns h; i-rows a stage, split over four groups
constexpr int kSm = 64, kSn = 64, kSi = 64, kSGroups = 4;
constexpr int kSThreads = kSGroups * 64;
constexpr int kSRows = kSi / kSGroups;         // a group's i-rows of a stage
constexpr int kSTile = kSi * kSm;              // floats in one stage's A, g or out tile
constexpr int kSRed = kSn + 4;                 // row stride of the partial tiles
// tc: gxw tile rows k (a consumer warpgroup per 64), columns h; i-rows a stage
constexpr int kCm = 128, kCn = 128, kCi = 64;
constexpr int kCConsumers = kCm / 64 * 128;
constexpr int kCThreads = kCConsumers + 128;   // and one producer warpgroup
constexpr int kCAtom = kCi * 128;              // bytes of a 64-wide atom of a stage's tile
constexpr int kCTile = 2 * kCAtom;             // bytes of one stage's A, g or out tile
constexpr int kCRed = kCn + 8;                 // row stride of the partial tile
static_assert(kSm == 64 && kSn == 64 && kSRows * kSGroups == kSi, "8 x 8 a thread");
static_assert(kCm == kCn, "A and g tiles share one layout");
static_assert(kDi * kDh / kThreads == 8, "dA: eight staged elements a thread");

// the gradients asked for, as bits of ``flags``
enum : int { kA = 1, kX = 2, kW = 4 };

__host__ __device__ constexpr int small_floats(int n, int m, int h, int f) {
  return n * (m | 1) + n * h + m * h + m * f + f * h;
}
__host__ __device__ constexpr int da_floats(int f) { return 2 * kDh * kDs + kDk * f + f * kDh; }
// the tiled variants' dynamic shared memory: 1024-byte alignment slack, the
// ring (A, g and out a stage) and its mbarriers (tc: full and empty)
// (simt: and the gy tile; tc: full and empty)
constexpr int kSimtSmem = 1024 + (kStages * 3 + 1) * kSTile * 4 + kStages * 8;
constexpr int kTcSmem = 1024 + kStages * 3 * kCTile + 2 * kStages * 8;
// the epilogue's scratch (partials, own rows, X and W) fits in the ring
static_assert((kSGroups * kSm * kSRed + kSm * kSRed + kSm * kMaxFusedF + kMaxFusedF * kSn) * 4 <=
                  (kStages * 3 + 1) * kSTile * 4, "simt epilogue");
static_assert((2 * kCm * kCRed + kCm * kMaxFusedF + kMaxFusedF * kCn) * 4 <= kStages * 3 * kCTile,
              "tc epilogue");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// dL/dy of act at one element, from g and the forward's output there (see
// the header; 0 where g is 0); __fmul_rn / __fadd_rn keep the compiler from
// fusing what torch rounds twice
template <typename T>
__device__ __forceinline__ float grad_y(T gt, T ot, float leak, int has_leak) {
  const float gv = to_f(gt);
  if (!has_leak) return gv;
  const float ov = to_f(ot);
  if (ov > 0.f) return gv;
  if (signbit(ov)) return round_to<T>(__fmul_rn(leak, gv));
  const float t = round_to<T>(__fmul_rn(0.5f, gv));
  return round_to<T>(__fadd_rn(t, round_to<T>(__fmul_rn(leak, t))));
}

// g and out at e (out only with act: it may be null otherwise)
template <typename T>
__device__ __forceinline__ float grad_y_at(const T* g, const T* o, int64_t e, float leak,
                                           int has_leak) {
  return grad_y<T>(g[e], has_leak ? o[e] : g[e], leak, has_leak);
}

// grad_y<float> of four values: g where out > 0, leak * g where out < 0;
// four that hold an out of +-0 or NaN take grad_y value by value
__device__ __forceinline__ float4 grad_y4(float4 g, float4 o, float leak) {
  if (!((o.x > 0.f || o.x < 0.f) && (o.y > 0.f || o.y < 0.f) && (o.z > 0.f || o.z < 0.f) &&
        (o.w > 0.f || o.w < 0.f)))
    return make_float4(grad_y<float>(g.x, o.x, leak, 1), grad_y<float>(g.y, o.y, leak, 1),
                       grad_y<float>(g.z, o.z, leak, 1), grad_y<float>(g.w, o.w, leak, 1));
  return make_float4(o.x > 0.f ? g.x : __fmul_rn(leak, g.x), o.y > 0.f ? g.y : __fmul_rn(leak, g.y),
                     o.z > 0.f ? g.z : __fmul_rn(leak, g.z), o.w > 0.f ? g.w : __fmul_rn(leak, g.w));
}

struct Args {
  const void *a, *x, *w, *out, *g;
  void *gx, *gw, *ga;     // gx: [B,m,f] where W is fused, else gxw [B,m,h]
  float* part;            // the partial gW, [parts][f*h]
  unsigned* counter;
  int batch, n, m, h, f;  // f = 0: no W in the kernel
  float leak;
  int has_leak, flags;
  int h_tiles;                   // tiled: column tiles of gxw
  int i_bound[kMaxSplit + 1];    // tiled: cluster rank r sums i in [i_bound[r], i_bound[r+1])
  int pair_a, pair_g;            // tc without TMA: 4-byte cp.async pairs
};

// The sum of the partial gW over the grid: every block, its partials
// written and fenced, takes one atomic increment of the counter; the block
// that takes the last one sums part[parts][f*h] over parts in order,
// writes gW and resets the counter for the next launch on this stream.
template <typename T>
__device__ void finish_gw(const Args& p, int parts) {
#ifndef SKIP_ELECTION
  __shared__ bool last;
  __threadfence();   // this thread's partials, GPU-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.counter, 1u) == gridDim.x * gridDim.y * gridDim.z - 1u;
    if (last) __threadfence();   // acquire: the other blocks' partials
  }
  __syncthreads();
  if (!last) return;
#ifndef SKIP_LAST_SUM
  const int cols = p.f * p.h;
  T* gw = static_cast<T*>(p.gw);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < parts; ++q) s += __ldcg(p.part + static_cast<int64_t>(q) * cols + c);
    gw[c] = from_f<T>(s);
  }
#endif
  if (threadIdx.x == 0) *p.counter = 0u;
#endif
}

// ---------------------------------------------------------------- small

template <typename T>
__global__ void __launch_bounds__(kThreads) adj_bwd_small_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, h = p.h, f = p.f, tid = threadIdx.x, lda = m | 1;
  const int64_t b = blockIdx.x;
  float* as = smem;              // A [n][lda]
  float* gys = as + n * lda;     // gy [n][h]
  float* gxws = gys + n * h;     // gxw [m][h], rounded to T
  float* xs = gxws + m * h;      // X [m][f]
  float* ws = xs + m * f;        // W [f][h]
  const T* a = static_cast<const T*>(p.a) + b * n * m;
  const T* g = static_cast<const T*>(p.g) + b * n * h;
  const T* o = static_cast<const T*>(p.out) + b * n * h;
  for (int e = tid; e < n * m; e += kThreads) as[(e / m) * lda + e % m] = to_f(a[e]);
  for (int e = tid; e < n * h; e += kThreads) gys[e] = grad_y_at<T>(g, o, e, p.leak, p.has_leak);
  if (f) {
    const T* x = static_cast<const T*>(p.x) + b * m * f;
    const T* w = static_cast<const T*>(p.w);
    for (int e = tid; e < m * f; e += kThreads) xs[e] = to_f(x[e]);
    for (int e = tid; e < f * h; e += kThreads) ws[e] = to_f(w[e]);
  }
  __syncthreads();

  // gxw[k, c] = sum_i A[i, k] gy[i, c]: the columns c of a row k are
  // neighbouring threads, so a warp reads a broadcast of A and a row of gy
  T* gx = static_cast<T*>(p.gx);
  for (int e = tid; e < m * h; e += kThreads) {
    const int k = e / h, c = e % h;
    float s[4] = {0.f, 0.f, 0.f, 0.f};   // four chains over i overlap their latency
    int i = 0;
    for (; i + 4 <= n; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = fmaf(as[(i + u) * lda + k], gys[(i + u) * h + c], s[u]);
    }
    for (; i < n; ++i) s[0] = fmaf(as[i * lda + k], gys[i * h + c], s[0]);
    const float v = round_to<T>((s[0] + s[1]) + (s[2] + s[3]));
    if (f)
      gxws[e] = v;
    else
      gx[b * m * h + e] = from_f<T>(v);
  }
  if (!f) return;
  __syncthreads();

  if (p.flags & kX) {   // gx[k, q] = sum_c gxw[k, c] W[q, c]
    for (int e = tid; e < m * f; e += kThreads) {
      const int k = e / f, q = e % f;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int c = 0;
      for (; c + 4 <= h; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(gxws[k * h + c + u], ws[q * h + c + u], s[u]);
      }
      for (; c < h; ++c) s[0] = fmaf(gxws[k * h + c], ws[q * h + c], s[0]);
      gx[b * m * f + e] = from_f<T>((s[0] + s[1]) + (s[2] + s[3]));
    }
  }
  if (p.flags & kW) {   // this graph's partial gW[q, c] = sum_k X[k, q] gxw[k, c]
    for (int e = tid; e < f * h; e += kThreads) {
      const int q = e / h, c = e % h;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int k = 0;
      for (; k + 4 <= m; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(xs[(k + u) * f + q], gxws[(k + u) * h + c], s[u]);
      }
      for (; k < m; ++k) s[0] = fmaf(xs[k * f + q], gxws[k * h + c], s[0]);
      p.part[b * f * h + e] = (s[0] + s[1]) + (s[2] + s[3]);
    }
    finish_gw<T>(p, p.batch);
  }
}

// ------------------------------------------------ the tiled epilogue

// four sums rounded to T into o[0 .. min(4, left)): one 16-byte (f32) or
// 8-byte (bf16) store where all four fit and o is aligned for it
template <typename T>
__device__ __forceinline__ void store4(T* o, float4 s, int left) {
  struct alignas(4 * sizeof(T)) Four { T v[4]; };
  const Four q = {{from_f<T>(s.x), from_f<T>(s.y), from_f<T>(s.z), from_f<T>(s.w)}};
  if (left >= 4 && reinterpret_cast<uintptr_t>(o) % sizeof(Four) == 0) {
    *reinterpret_cast<Four*>(o) = q;
  } else {
    for (int j = 0; j < 4 && j < left; ++j) o[j] = q.v[j];
  }
}

// After the i loop: each block of the cluster holds its partial f32 tile
// [kRows][kCols] (rows kStride apart) at `red`.  Rank r sums rows [r*R,
// (r+1)*R), R = kRows / S, over the ranks in rank order, every rank's read
// in flight at once (ld.shared::cluster), and rounds them to T; without W
// they are gxw's rows, stored to gx; with W they go to `own` [R][kStride],
// from which the rank forms gx = gxw W^T for its rows and its partial gW =
// X^T gxw (part row `part_id`), and the grid's election sums gW.  `own` and
// the X and W slices after it lie apart from `red`, which the other ranks
// read until the second cluster barrier.
template <typename T, int kRows, int kCols, int kStride>
__device__ void tile_epilogue(const Args& p, const float* red, float* own, int k0, int c0,
                              int64_t b) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = kRows / split, r0 = rank * rows;
  const int f = p.f, m = p.m, h = p.h, tid = threadIdx.x, nt = blockDim.x;
  float* xs = own + kRows * kStride;    // X [rows][kMaxFusedF] of the rank's rows
  float* ws = xs + kRows * kMaxFusedF;  // W [f][kCols]
  if (f) {
    const T* x = static_cast<const T*>(p.x) + b * m * f;
    const T* w = static_cast<const T*>(p.w);
    for (int e = tid; e < rows * f; e += nt) {
      const int k = k0 + r0 + e / f;
      xs[(e / f) * kMaxFusedF + e % f] = k < m ? to_f(x[static_cast<int64_t>(k) * f + e % f]) : 0.f;
    }
    for (int e = tid; e < f * kCols; e += nt) {
      const int c = c0 + e % kCols;
      ws[e] = c < h ? to_f(w[static_cast<int64_t>(e / kCols) * h + c]) : 0.f;
    }
  }
  cluster.sync();   // every rank's partial tile is in its shared memory
  T* gx = static_cast<T*>(p.gx);
  for (int e = tid; e < rows * (kCols / 4); e += nt) {
    const int lr = e / (kCols / 4), r = r0 + lr, c = (e % (kCols / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#ifndef SKIP_REDUCE
    float4 v[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < split) v[q] = hk::ld_cluster_f4(red + r * kStride + c, q);
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < split) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
#else   // kept local: the products stay, the exchange goes
    s = *reinterpret_cast<const float4*>(red + r * kStride + c);
#endif
    if (f) {
      *reinterpret_cast<float4*>(own + lr * kStride + c) = make_float4(
          round_to<T>(s.x), round_to<T>(s.y), round_to<T>(s.z), round_to<T>(s.w));
    } else if (k0 + r < m && c0 + c < h) {
      store4(gx + (b * m + k0 + r) * h + c0 + c, s, h - c0 - c);
    }
  }
  cluster.sync();   // the other ranks' reads of this block's tile are done
  if (!f) return;
  const int hc = (h + 3) & ~3;   // the columns past h are zero in own and ws
  if (p.flags & kX) {   // gx[k, q] = sum_c gxw[k, c] W[q, c]
    for (int e = tid; e < rows * f; e += nt) {
      const int lr = e / f, q = e % f, k = k0 + r0 + lr;
      if (k >= m) continue;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < hc; c += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(own[lr * kStride + c + u], ws[q * kCols + c + u], s[u]);
      gx[(b * m + k) * f + q] = from_f<T>((s[0] + s[1]) + (s[2] + s[3]));
    }
  }
  if (p.flags & kW) {   // the rows' partial gW[q, c] = sum_k X[k, q] gxw[k, c]
    const int64_t part_id =
        blockIdx.x + static_cast<int64_t>(gridDim.x) * (blockIdx.y + gridDim.y * blockIdx.z);
    float* part = p.part + part_id * f * h;
    for (int e = tid; e < f * h; e += nt) {
      const int q = e / h, c = e % h;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int lr = 0;
      for (; lr + 4 <= rows; lr += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[u] = fmaf(xs[(lr + u) * kMaxFusedF + q], own[(lr + u) * kStride + c], s[u]);
      for (; lr < rows; ++lr) s[0] = fmaf(xs[lr * kMaxFusedF + q], own[lr * kStride + c], s[0]);
      part[e] = (s[0] + s[1]) + (s[2] + s[3]);
    }
    finish_gw<T>(p, static_cast<int>(gridDim.x * gridDim.y * gridDim.z));
  }
}

// ------------------------------------------------------------ simt (f32)

// One block per SM; block (rank, tile, b) sums i over the rank's slice for
// the 64 x 64 gxw tile (k0, c0).  Stage s holds A [kSi][kSm], g and out
// [kSi][kSn], dense; group gr takes i-rows [gr*kSRows, (gr+1)*kSRows) of
// every stage for the whole tile, thread (ty, tx) of a group k rows 4ty +
// [0,4), 32 + 4ty + [0,4) and columns 4tx + [0,4), 32 + 4tx + [0,4).
__global__ void __launch_bounds__(kSThreads, 1)
adj_bwd_simt_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_o, const __grid_constant__ Args p,
                    int tma_a, int tma_g) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw +
                                         ((1024 - (hk::smem_u32(smem_raw) & 1023)) & 1023));
  float* gys = smem + kStages * 3 * kSTile;   // gy [kSi][kSn] (act only)
  uint64_t* full = reinterpret_cast<uint64_t*>(gys + kSTile);
  const int tid = threadIdx.x, gr = tid / 64, lt = tid % 64, ty = lt / 8, tx = lt % 8;
  const int rank = blockIdx.x;
  const int k0 = (blockIdx.y / p.h_tiles) * kSm, c0 = (blockIdx.y % p.h_tiles) * kSn;
  const int64_t b = blockIdx.z;
  const int n = p.n, m = p.m, h = p.h, leaky = p.has_leak;
  const float* ab = static_cast<const float*>(p.a) + b * n * m;
  const float* gb = static_cast<const float*>(p.g) + b * n * h;
  const float* ob = static_cast<const float*>(p.out) + (leaky ? b * n * h : 0);
  const int it0 = p.i_bound[rank] / kSi;
  const int nk = (p.i_bound[rank + 1] + kSi - 1) / kSi - it0;
  const bool any_tma = tma_a || tma_g;
  const int quads = min(kSn / 4, (h - c0 + 3) / 4);   // float4s of a row holding columns below h

  if (tid == 0 && any_tma) {
    for (int s = 0; s < kStages; ++s) hk::mbar_init(full + s, 1);   // thread 0 and the TMA
    hk::mbar_init_fence();
  }
  if (leaky && quads < kSn / 4)
    for (int e = tid; e < kSTile / 4; e += kSThreads)
      reinterpret_cast<float4*>(gys)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  auto load = [&](int t, int s) {   // i-step t into stage s
#ifndef SKIP_LOADS
    const int i0 = t * kSi;
    float* a_s = smem + s * 3 * kSTile;
    float* g_s = a_s + kSTile;
    float* o_s = g_s + kSTile;
    if (tid == 0 && any_tma) {   // the TMA zero-fills past the edges
      hk::fence_proxy_async();   // after every thread's accesses of the stage (the barrier)
      hk::mbar_arrive_expect_tx(
          full + s, (tma_a ? kSTile * 4 : 0) + (tma_g ? kSTile * 4 * (1 + leaky) : 0));
      if (tma_a) hk::tma_load_3d(a_s, &map_a, full + s, k0, i0, static_cast<int>(b));
      if (tma_g) {
        hk::tma_load_3d(g_s, &map_g, full + s, c0, i0, static_cast<int>(b));
        if (leaky) hk::tma_load_3d(o_s, &map_o, full + s, c0, i0, static_cast<int>(b));
      }
    }
    if (!tma_a) {
      for (int e = tid; e < kSTile; e += kSThreads) {
        const int r = e / kSm, kk = e % kSm;
        const bool ok = i0 + r < n && k0 + kk < m;
        hk::cp_async4(a_s + e, ab + (ok ? static_cast<int64_t>(i0 + r) * m + k0 + kk : 0), ok);
      }
    }
    if (!tma_g) {
      for (int e = tid; e < kSTile; e += kSThreads) {
        const int r = e / kSn, c = e % kSn;
        const bool ok = i0 + r < n && c0 + c < h;
        const int64_t at = ok ? static_cast<int64_t>(i0 + r) * h + c0 + c : 0;
        hk::cp_async4(g_s + e, gb + at, ok);
        if (leaky) hk::cp_async4(o_s + e, ob + at, ok);
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
    if (s < nk) load(it0 + s, s);
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
    if (nt < nk) load(it0 + nt, nt % kStages);
    hk::cp_async_commit();
    const float* a_g = smem + s * 3 * kSTile + gr * kSRows * kSm;   // this group's i-rows
    const float* g_g = smem + s * 3 * kSTile + kSTile + gr * kSRows * kSn;
    if (leaky) {   // gy = grad_y(g, out) over the group's rows, into the gy tile
      float4* gy4 = reinterpret_cast<float4*>(gys + gr * kSRows * kSn);
#ifndef SKIP_GY
      const float4* g4 = reinterpret_cast<const float4*>(g_g);
      const float4* o4 = reinterpret_cast<const float4*>(g_g + kSTile);
      // only the columns below h: the gy tile's others stay zero
      for (int e = lt; e < kSRows * quads; e += 64) {
        const int r = quads == kSn / 4 ? e / (kSn / 4) : e / quads;   // a shift for full rows
        const int v = r * (kSn / 4) + e - r * quads;
        gy4[v] = grad_y4(g4[v], o4[v], p.leak);
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + gr) : "memory");
#endif
      g_g = reinterpret_cast<const float*>(gy4);
    }
#ifndef SKIP_MMA
#pragma unroll
    for (int ii = 0; ii < kSRows; ++ii) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_g + ii * kSm + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a_g + ii * kSm + 32 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(g_g + ii * kSn + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(g_g + ii * kSn + 32 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#endif
  }
  hk::cp_async_wait_all();

  // the groups' partial tiles meet in the freed ring and are summed in
  // group order into group 0's, which the cluster then reads
  __syncthreads();
  float* part = smem;   // [kSGroups][kSm][kSRed]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + (gr * kSm + (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4)) * kSRed;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int e = tid; e < kSm * kSn / 4; e += kSThreads) {
    const int r = e / (kSn / 4), c = (e % (kSn / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kSGroups; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(part + (q * kSm + r) * kSRed + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(part + r * kSRed + c) = sum;
  }
  tile_epilogue<float, kSm, kSn, kSRed>(p, part, part + kSGroups * kSm * kSRed, k0, c0, b);
}

// ------------------------------------------------------------- tc (bf16)

// byte offset of element (r, c) of a stage's [kCi][128] tile: two 64-wide
// atoms of 128-byte rows in TMA's SWIZZLE_128B layout (the 16-byte chunk j
// of row r at j ^ (r & 7)), as wgmma's MN-major operands read them
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * kCAtom + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void store_pair(unsigned char* d, bf16 v0, bf16 v1) {
  __nv_bfloat162 v;
  v.x = v0;
  v.y = v1;
  *reinterpret_cast<__nv_bfloat162*>(d) = v;
}

// rows [r0, r0 + kCi) and columns [c0, c0 + 128) of a [rows][cols] bf16
// matrix into a stage's tile without TMA, zero past the last row, by the
// producer warpgroup (pt: the thread's index in it): 4-byte cp.async pairs
// (even cols and a 4-byte aligned start) or plain loads and stores.  The
// columns past cols are not written: the kernel zeroed them for good.
__device__ void load_tile_manual(unsigned char* dst, const bf16* src, int rows, int cols, int r0,
                                 int c0, bool pair, int pt) {
  const bf16 zero = __float2bfloat16(0.f);
  const int pairs = min(kCn / 2, (cols - c0 + 1) / 2);   // column pairs of the row in the tile
  const int total = kCi * pairs;
  if (pair) {
    for (int e = pt; e < total; e += 128) {
      const int r = e / pairs, c = (e % pairs) * 2, gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      hk::cp_async4(dst + sw_off(r, c), src + (ok ? static_cast<int64_t>(gr) * cols + gc : 0), ok);
    }
    return;
  }
  constexpr int kBatch = 8;   // plain loads: a batch's loads all issued before its stores
  for (int e0 = pt; e0 < total; e0 += 128 * kBatch) {
    bf16 v[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * 128, r = e / pairs, c = (e % pairs) * 2, gr = r0 + r, gc = c0 + c;
      const int64_t at = static_cast<int64_t>(gr) * cols + gc;
      v[u][0] = e < total && gr < rows && gc < cols ? src[at] : zero;
      v[u][1] = e < total && gr < rows && gc + 1 < cols ? src[at + 1] : zero;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * 128;
      if (e < total) store_pair(dst + sw_off(e / pairs, (e % pairs) * 2), v[u][0], v[u][1]);
    }
  }
}

// grad_y<bf16> of eight values (16 bytes of g and of out), the same
// roundings: g where out > 0, round(leak * g) where out < 0, each pair's two
// products rounded by one bf16x2 conversion, out's sign read by packed
// compares; eight that hold an out of +-0 or NaN take grad_y<bf16> value by
// value
__device__ __forceinline__ uint4 grad_y8(uint4 g8, uint4 o8, float leak) {
  uint32_t g[4] = {g8.x, g8.y, g8.z, g8.w};
  const uint32_t o[4] = {o8.x, o8.y, o8.z, o8.w};
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  uint32_t pos[4], other = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 oj = *reinterpret_cast<const __nv_bfloat162*>(&o[j]);
    pos[j] = __hgt2_mask(oj, zero);
    other |= ~(pos[j] | __hlt2_mask(oj, zero));
  }
  if (other) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0 = grad_y<bf16>(__ushort_as_bfloat16(g[j] & 0xffffu),
                                    __ushort_as_bfloat16(o[j] & 0xffffu), leak, 1);
      const float v1 = grad_y<bf16>(__ushort_as_bfloat16(g[j] >> 16),
                                    __ushort_as_bfloat16(o[j] >> 16), leak, 1);
      g[j] = (__float_as_uint(v0) >> 16) | (__float_as_uint(v1) & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 n =
          __floats2bfloat162_rn(__fmul_rn(leak, __uint_as_float(g[j] << 16)),
                                __fmul_rn(leak, __uint_as_float(g[j] & 0xffff0000u)));
      g[j] = (g[j] & pos[j]) | (*reinterpret_cast<const uint32_t*>(&n) & ~pos[j]);
    }
  }
  return make_uint4(g[0], g[1], g[2], g[3]);
}

// One block per SM; block (rank, tile, b) sums i over the rank's slice for
// the 128 x 128 gxw tile (k0, c0).  Stage s holds A [kCi][128 k], g and out
// [kCi][128 c] in the swizzled layout of sw_off; consumer warpgroup wg owns
// k rows [64wg, 64wg + 64): its A operand is the atom wg of the A tile.
// With act, the consumers turn step j + 1's g into gy in place while the
// tensor cores run step j's wgmma (issued, not yet waited on).
__global__ void __launch_bounds__(kCThreads, 1)
adj_bwd_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_g,
                  const __grid_constant__ CUtensorMap map_o, const __grid_constant__ Args p,
                  int tma_a, int tma_g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hk::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStage = 3 * kCTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int k0 = (blockIdx.y / p.h_tiles) * kCm, c0 = (blockIdx.y % p.h_tiles) * kCn;
  const int64_t b = blockIdx.z;
  const int n = p.n, m = p.m, h = p.h, leaky = p.has_leak;
  const int it0 = p.i_bound[rank] / kCi;
  const int nk = (p.i_bound[rank + 1] + kCi - 1) / kCi - it0;
  const bool tma_only = tma_a && tma_g;
  // a TMA box wholly past m or h is not issued, and the copies without TMA
  // skip the columns past m or h: the ring starts zero, which those keep
  const bool two_a = k0 + 64 < m, two_g = c0 + 64 < h;
  if (k0 + kCm > m || c0 + kCn > h) {
    for (int e = tid; e < kStages * kStage / 16; e += kCThreads)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    hk::fence_proxy_async();
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // every producer thread and the TMA, or the TMA alone
      hk::mbar_init(full + s, tma_only ? 1 : 128 + (tma_a || tma_g));
      hk::mbar_init(empty + s, kCConsumers / 32);   // each consumer warp arrives
    }
    hk::mbar_init_fence();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (tid >= kCConsumers) {   // producer warpgroup
    const int pt = tid - kCConsumers;
    const bf16* ab = static_cast<const bf16*>(p.a) + b * n * m;
    const bf16* gb = static_cast<const bf16*>(p.g) + b * n * h;
    const bf16* ob = static_cast<const bf16*>(p.out) + (leaky ? b * n * h : 0);
    for (int it = 0; it < nk && (pt == 0 || !tma_only); ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      hk::mbar_wait(empty + s, ph ^ 1);
      const int i0 = (it0 + it) * kCi;
      unsigned char* a_s = smem + s * kStage;
      unsigned char* g_s = a_s + kCTile;
      unsigned char* o_s = g_s + kCTile;
#ifndef SKIP_LOADS
      if (!tma_only) {
        if (!tma_a) load_tile_manual(a_s, ab, n, m, i0, k0, p.pair_a, pt);
        if (!tma_g) {
          load_tile_manual(g_s, gb, n, h, i0, c0, p.pair_g, pt);
          if (leaky) load_tile_manual(o_s, ob, n, h, i0, c0, p.pair_g, pt);
        }
        const bool stored = (!tma_a && !p.pair_a) || (!tma_g && !p.pair_g);
        if (!stored) {   // arrives once this thread's copies land
          hk::mbar_cp_async_arrive(full + s);
        } else {         // plain stores: wait, make them visible to wgmma, arrive
          hk::cp_async_wait_all();
          hk::fence_proxy_async();
          hk::mbar_arrive(full + s);
        }
      }
      if (pt == 0 && (tma_a || tma_g)) {
        hk::mbar_arrive_expect_tx(full + s, (tma_a ? kCAtom * (1 + two_a) : 0) +
                                                (tma_g ? kCAtom * (1 + two_g) * (1 + leaky) : 0));
        if (tma_a) {
          hk::tma_load_3d(a_s, &map_a, full + s, k0, i0, static_cast<int>(b));
          if (two_a) hk::tma_load_3d(a_s + kCAtom, &map_a, full + s, k0 + 64, i0, static_cast<int>(b));
        }
        if (tma_g) {
          hk::tma_load_3d(g_s, &map_g, full + s, c0, i0, static_cast<int>(b));
          if (two_g) hk::tma_load_3d(g_s + kCAtom, &map_g, full + s, c0 + 64, i0, static_cast<int>(b));
          if (leaky) {
            hk::tma_load_3d(o_s, &map_o, full + s, c0, i0, static_cast<int>(b));
            if (two_g)
              hk::tma_load_3d(o_s + kCAtom, &map_o, full + s, c0 + 64, i0, static_cast<int>(b));
          }
        }
      }
#else
      if (!tma_only) hk::mbar_arrive(full + s);
      if (pt == 0 && (tma_a || tma_g)) hk::mbar_arrive(full + s);
#endif
    }
  } else {   // consumer warpgroups, 64 k-rows of the tile each
    const int wg = tid / 128, chunks = min(kCn / 8, (h - c0 + 7) / 8);
    // step j's stage landed, and with act its g turned into gy in place (16
    // bytes at a time by all consumer threads), visible to wgmma
    auto stage_ready = [&](int j) {
      const int sj = j % kStages;
      hk::mbar_wait(full + sj, (j / kStages) & 1);
      if (!tma_only) hk::fence_proxy_async();   // copies by the threads, read by wgmma
      if (leaky) {
#ifndef SKIP_GY
        // only the 16-byte chunks that hold columns below h: the rest are
        // zero in g, and so in gy
        unsigned char* g_j = smem + sj * kStage + kCTile;
        for (int e = tid; e < kCi * chunks; e += kCConsumers) {
          const int r = chunks == kCn / 8 ? e / (kCn / 8) : e / chunks;   // a shift for full rows
          const int off = sw_off(r, (e - r * chunks) * 8);
          uint4* gp = reinterpret_cast<uint4*>(g_j + off);
          *gp = grad_y8(*gp, *reinterpret_cast<const uint4*>(g_j + kCTile + off), p.leak);
        }
        hk::fence_proxy_async();
#endif
        asm volatile("bar.sync 1, %0;\n" ::"n"(kCConsumers) : "memory");
      }
    };
    if (nk > 0) stage_ready(0);
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      unsigned char* a_s = smem + s * kStage;
      unsigned char* g_s = a_s + kCTile;
#ifndef SKIP_MMA
      hk::fence_regs(acc);
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCi / 16; ++kk) {
        const uint64_t da = hk::gmma_desc(a_s + wg * kCAtom + kk * 16 * 128, kCAtom, 1024);
        const uint64_t db = hk::gmma_desc(g_s + kk * 16 * 128, kCAtom, 1024);
        hk::wgmma_m64n128k16_bf16<1>(acc, da, db);
      }
      hk::wgmma_commit();
#endif
      if (it + 1 < nk) stage_ready(it + 1);   // while the tensor cores run this step
#ifndef SKIP_MMA
      hk::wgmma_wait_all();
      hk::fence_regs(acc);
#endif
      __syncwarp();   // the warp's reads of the stage are done
      if (tid % 32 == 0) hk::mbar_arrive(empty + s);
    }
  }
  __syncthreads();

  // [kCm][kCn] with rows kCRed apart (the accumulator layout's stores hit 8
  // rows at once), over the ring
  float* red = reinterpret_cast<float*>(smem);
  if (tid < kCConsumers) {   // wgmma's accumulator layout: warp w of the warpgroup owns 16 rows
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int r = (tid / 128) * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kCn / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(red + r * kCRed + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(red + (r + 8) * kCRed + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  tile_epilogue<bf16, kCm, kCn, kCRed>(p, red, red + kCm * kCRed, k0, c0, b);
}

// ---------------------------------------------------------------- dA

// gA[b, i, k] = round_T(sum_c gy[i, c] xw[k, c]), xw = X (no W here) or
// round_T(X @ W) recomputed per 32-column step; both staged transposed
// ([c][i], [c][k]) so that each step reads rows of four
template <typename T>
__global__ void __launch_bounds__(kThreads) adj_bwd_da_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int f = p.f, k_tiles = (p.m + kDk - 1) / kDk;
  const int i0 = static_cast<int>(blockIdx.x) / k_tiles * kDi;
  const int k0 = static_cast<int>(blockIdx.x) % k_tiles * kDk;
  const int64_t b = blockIdx.y;
  float* gs = smem;               // gy [kDh][kDs]
  float* xws = gs + kDh * kDs;    // xw [kDh][kDs]
  float* xs = xws + kDh * kDs;    // X [kDk][f]
  float* ws = xs + kDk * f;       // W [f][kDh]
  const T* g = static_cast<const T*>(p.g) + b * p.n * p.h;
  const T* o = static_cast<const T*>(p.out) + b * p.n * p.h;
  const T* x = static_cast<const T*>(p.x) + b * p.m * (f ? f : p.h);
  if (f) {
    for (int e = tid; e < kDk * f; e += kThreads) {
      const int k = k0 + e / f;
      xs[e] = k < p.m ? to_f(x[static_cast<int64_t>(k) * f + e % f]) : 0.f;
    }
  }
  float acc[4][4] = {};
  for (int c0 = 0; c0 < p.h; c0 += kDh) {
    __syncthreads();   // the last step's reads are done
    constexpr int kPerD = kDi * kDh / kThreads;
    T gv[kPerD], ov[kPerD];   // every load issued before any is used
#pragma unroll
    for (int e = 0; e < kPerD; ++e) {
      const int idx = tid + e * kThreads, i = i0 + idx / kDh, c = c0 + idx % kDh;
      const bool ok = i < p.n && c < p.h;
      const int64_t off = ok ? static_cast<int64_t>(i) * p.h + c : 0;
      gv[e] = g[off];
      ov[e] = p.has_leak ? o[off] : gv[e];
      if (!ok) gv[e] = from_f<T>(0.f);
    }
#pragma unroll
    for (int e = 0; e < kPerD; ++e) {
      const int idx = tid + e * kThreads;
      gs[(idx % kDh) * kDs + idx / kDh] = grad_y<T>(gv[e], ov[e], p.leak, p.has_leak);
    }
    if (f) {
      const T* w = static_cast<const T*>(p.w);
      for (int e = tid; e < f * kDh; e += kThreads) {
        const int c = c0 + e % kDh;
        ws[e] = c < p.h ? to_f(w[(e / kDh) * p.h + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kDk * kDh / kThreads; ++e) {
        const int idx = tid + e * kThreads, r = idx / kDh, c = idx % kDh;
        float s = 0.f;
        for (int q = 0; q < f; ++q) s = fmaf(xs[r * f + q], ws[q * kDh + c], s);
        xws[c * kDs + r] = round_to<T>(s);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kDk * kDh / kThreads; ++e) {
        const int idx = tid + e * kThreads, r = idx / kDh, c = c0 + idx % kDh;
        const int k = k0 + r;
        xws[(idx % kDh) * kDs + r] =
            k < p.m && c < p.h ? to_f(x[static_cast<int64_t>(k) * p.h + c]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDh; ++c) {
      const float4 gv4 = *reinterpret_cast<const float4*>(gs + c * kDs + 4 * tr);
      const float4 xv = *reinterpret_cast<const float4*>(xws + c * kDs + 4 * tc);
      const float gr[4] = {gv4.x, gv4.y, gv4.z, gv4.w}, xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gr[r], xr[q], acc[r][q]);
    }
  }
  T* ga = static_cast<T*>(p.ga);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * tr + r;
    if (i >= p.n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * tc + q;
      if (k < p.m) ga[(b * p.n + i) * p.m + k] = from_f<T>(acc[r][q]);
    }
  }
}

}  // namespace

// What adj_matmul_backward_plan picked: the launch checks it against the
// kernels' sizes above and launches it as it stands, so the plan the CPU
// tests hold is the one that runs.
struct BackwardPlan {
  int variant;       // 0 = small, 1 = simt (f32), 2 = tc (bf16)
  int fuse_w;        // W's products in the kernel
  int threads, smem;
  int grid[3];       // tiled: (split, k_tiles * h_tiles, batch)
  int split;         // tiled: the i-split, which is the cluster size
  int tile[3];       // tiled: gxw rows k, columns h, and the i step
  int i_bound[kMaxSplit + 1];   // rank r takes i in [i_bound[r], i_bound[r+1])
  int stages;
  int tma_a, tma_g;  // tiled: A / g and out by TMA
  int k_tiles, h_tiles;
  int parts;         // rows of the partial gW (0: gW not asked or not fused)
  int da_grid[3];    // the dA kernel (0s where dA is not asked)
  int da_smem;
};

namespace {

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// the i-slices cover [0, n) once, in rank order, on i-step boundaries; none
// is empty when i is split
bool i_slices_ok(const BackwardPlan& lp, int n, int step) {
  if (lp.split < 1 || lp.split > kMaxSplit || (lp.split & (lp.split - 1)) ||
      lp.i_bound[0] != 0 || lp.i_bound[lp.split] != n)
    return false;
  for (int r = 0; r < lp.split; ++r) {
    const int lo = lp.i_bound[r], hi = lp.i_bound[r + 1];
    if (hi < lo || (lp.split > 1 && hi == lo) || lo % step != 0) return false;
  }
  return true;
}

template <typename T>
int launch_small(const Args& p, const BackwardPlan& lp, cudaStream_t st) {
  if (p.flags & (kX | kW)) {
    adj_bwd_small_kernel<T><<<dim3(lp.grid[0], lp.grid[1], lp.grid[2]), lp.threads, lp.smem,
                              st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int launch_da(const Args& p, const BackwardPlan& lp, cudaStream_t st) {
  adj_bwd_da_kernel<T><<<dim3(lp.da_grid[0], lp.da_grid[1], lp.da_grid[2]), kThreads,
                         lp.da_smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tiled kernel of `lp`, with TMA maps of A [batch][n][m] and g, out
// [batch][n][h] (boxes of 64 columns x the i step; tc with the 128-byte
// swizzle) where the plan asks for TMA
int launch_tiled(const Args& p, const BackwardPlan& lp, bool simt, cudaStream_t st) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int dtype = simt ? 0 : 1, step = simt ? kSi : kCi;
  const CUtensorMapSwizzle sw = simt ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_a = {}, map_g = {}, map_o = {};
  if (lp.tma_a && !hk::tensor_map(&map_a, p.a, dtype, p.m, p.n, p.batch, 64, step, sw)) return bad;
  if (lp.tma_g && (!hk::tensor_map(&map_g, p.g, dtype, p.h, p.n, p.batch, 64, step, sw) ||
                   (p.has_leak &&
                    !hk::tensor_map(&map_o, p.out, dtype, p.h, p.n, p.batch, 64, step, sw))))
    return bad;
  const dim3 grid(lp.grid[0], lp.grid[1], lp.grid[2]);
  return simt ? hk::launch_cluster(adj_bwd_simt_kernel, grid, lp.threads, lp.smem, lp.split, st,
                                   map_a, map_g, map_o, p, lp.tma_a, lp.tma_g)
              : hk::launch_cluster(adj_bwd_tc_kernel, grid, lp.threads, lp.smem, lp.split, st,
                                   map_a, map_g, map_o, p, lp.tma_a, lp.tma_g);
}

}  // namespace

// One call of what adj_matmul_backward_plan picked (`plan`).  a [batch,n,m];
// out and g [batch,n,h]; f: W's rows (0 without W); x [batch,m,f] with w
// [f,h] where the plan fuses W, else w is null and x is xw [batch,m,h],
// read only for gA (null otherwise).  gx:
// [batch,m,f] where W is fused, else gxw [batch,m,h]; gw [f,h]; ga
// [batch,n,m]; each null where ``flags`` (1 = gA, 2 = gx or gxw, 4 = gW)
// does not ask.  part: f32 [plan.parts][f*h] and counter: one unsigned, 0
// before the call and left 0 by it, used by one stream at a time; both
// needed only for gW.  dtype: 0 = float32, 1 = bfloat16.  has_leak: act is
// max(y, leak*y) (out read), else the identity.  A plan that does not
// match the kernels' sizes or the operands is refused with
// cudaErrorInvalidValue.  One kernel, two where gA is asked too.  Returns
// a cudaError_t.
extern "C" int adj_matmul_backward_launch(const void* a, const void* x, const void* w,
                                          const void* out, const void* g, void* gx, void* gw,
                                          void* ga, float* part, unsigned* counter, int batch,
                                          int n, int m, int h, int f, float leak, int has_leak,
                                          int flags, int dtype, const BackwardPlan* plan,
                                          void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || !plan || (flags & ~7) || batch < 0 || n < 0 || m < 0 ||
      h < 0 || f < 0)
    return bad;
  if (batch == 0 || n == 0 || m == 0 || h == 0 || flags == 0) return 0;
  const BackwardPlan& lp = *plan;
  const bool fuse = w != nullptr;
  const bool small = n <= kSmallMax && m <= kSmallMax &&
                     4LL * small_floats(n, m, h, f) <= kSmallMaxSmem;
  const bool simt = dtype == 0;
  const int tm = small ? 0 : simt ? kSm : kCm, tn = small ? 0 : simt ? kSn : kCn;
  const int step = small ? 0 : simt ? kSi : kCi;
  // the small variant always fuses W; the tiled ones up to kMaxFusedF rows
  // of W over one column tile
  if (fuse != (f > 0 && (small || (f <= kMaxFusedF && h <= tn))) ||
      lp.fuse_w != static_cast<int>(fuse) || ((flags & kW) && !fuse))
    return bad;
  const int fk = fuse ? f : 0;
  const int64_t k_tiles = small ? 0 : cdiv(m, tm), h_tiles = small ? 0 : cdiv(h, tn);
  const bool main_kernel = flags & (kX | kW);
  int64_t grid_x, grid_y, grid_z, smem, parts;
  if (small) {
    grid_x = batch, grid_y = grid_z = 1;
    smem = 4LL * small_floats(n, m, h, fk);
    parts = (flags & kW) ? batch : 0;
    if (lp.variant != 0 || lp.threads != kThreads || lp.split != 1 || lp.stages != 0 ||
        lp.tile[0] || lp.tile[1] || lp.tile[2] || lp.i_bound[0] != 0 || lp.i_bound[1] != n ||
        lp.tma_a || lp.tma_g || lp.k_tiles || lp.h_tiles)
      return bad;
  } else {
    grid_x = lp.split, grid_y = k_tiles * h_tiles, grid_z = batch;
    smem = simt ? kSimtSmem : kTcSmem;
    parts = (flags & kW) ? grid_x * grid_y * grid_z : 0;
    // TMA needs 16-byte rows and aligned starts
    const int per16 = simt ? 4 : 8;
    const bool tma_ok_a = m % per16 == 0 && aligned16(a);
    const bool tma_ok_g = h % per16 == 0 && aligned16(g) && (!has_leak || aligned16(out));
    if (lp.variant != 1 + dtype || lp.threads != (simt ? kSThreads : kCThreads) ||
        lp.stages != kStages || lp.tile[0] != tm || lp.tile[1] != tn || lp.tile[2] != step ||
        !i_slices_ok(lp, n, step) || lp.k_tiles != k_tiles || lp.h_tiles != h_tiles ||
        (lp.tma_a && !tma_ok_a) || (lp.tma_g && !tma_ok_g) || batch > 65535 ||
        grid_y > 65535 || cdiv(n, step) < lp.split)
      return bad;
  }
  const int64_t da_x = (flags & kA) ? cdiv(n, kDi) * cdiv(m, kDk) : 0;
  if ((main_kernel && (lp.grid[0] != grid_x || lp.grid[1] != grid_y || lp.grid[2] != grid_z ||
                       lp.smem != smem)) ||
      lp.parts != parts || parts > 0x7fffffffLL ||
      ((flags & kA) && (lp.da_grid[0] != da_x || lp.da_grid[1] != batch ||
                        lp.da_grid[2] != 1 || lp.da_smem != 4LL * da_floats(fk) ||
                        batch > 65535 || da_x > 0x7fffffffLL)))
    return bad;
  if (!a || !g || (has_leak && !out) || ((flags & kX) && !gx) ||
      ((flags & kW) && (!gw || !part || !counter)) || ((flags & kA) && (!ga || !x)) ||
      (fuse && !x))
    return bad;
  Args p{a, x, w, out, g, gx, gw, ga, part, counter, batch, n, m, h, fk, leak,
         has_leak, flags, static_cast<int>(h_tiles), {}, 0, 0};
  for (int r = 0; r <= kMaxSplit; ++r) p.i_bound[r] = lp.i_bound[r];
  p.pair_a = m % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  p.pair_g = h % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 4 == 0 &&
             (!has_leak || reinterpret_cast<uintptr_t>(out) % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code = 0;
  if (main_kernel)
    code = small ? (simt ? launch_small<float>(p, lp, st) : launch_small<bf16>(p, lp, st))
                 : launch_tiled(p, lp, simt, st);
  if (code == 0 && (flags & kA))
    code = simt ? launch_da<float>(p, lp, st) : launch_da<bf16>(p, lp, st);
  return code;
}

// How many clusters of `split` blocks of the tiled backward kernel for
// `dtype` (0: simt, 1: tc) the card holds at once, from
// cudaOccupancyMaxActiveClusters: the figures adj_matmul_backward_plan's
// H100_BWD_CLUSTERS table holds.
extern "C" int adj_matmul_backward_max_clusters(int dtype, int split, int* clusters) {
  return dtype == 0
             ? hk::max_clusters(adj_bwd_simt_kernel, kSThreads, kSimtSmem, split, clusters)
             : hk::max_clusters(adj_bwd_tc_kernel, kCThreads, kTcSmem, split, clusters);
}
