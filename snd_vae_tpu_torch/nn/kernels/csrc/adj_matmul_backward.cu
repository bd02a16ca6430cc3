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
// It replaces what the port ran as K3's backward before: autograd through
// the plain version, which recomputed the forward (x @ W, A @ xw, the
// maximum) and differentiated it, ~20 kernels per GraphConv.  The TPU
// kernel it stands beside, blocked_adj_matmul (snd_vae_tpu/nn/pallas/
// blocked_spmm.py:89, pallas_call :126), has no backward: pallas_call has
// no transpose rule, and JAX's GraphConv (snd_vae_tpu/nn/graph_conv.py:
// 29-45) is two einsums that XLA differentiates.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 on CUDA cores):
//   * the served GraphConvs, [10,25,25] with F,H = 1,10 and 11,20: ~20-60 KB
//     and ~0.1 MFLOP, ~0.02 us: the launch and the chain of dependent
//     shared-memory phases bound it, so one launch does all of it;
//   * [8192,8192] @ [8192,128]: A^T @ gy is 17.2 GFLOP, 256 us of f32
//     operations; on CUDA cores bf16 is bound by the same operations
//     (its tensor-core bound, 40 us of bytes, is not reached here).
//
// Design, two variants and a second kernel; adj_matmul_backward_plan
// (adj_matmul.py) picks them and their sizes from the shapes alone, and the
// launch below checks what it picked against the sizes here:
//   small  (n, m <= 64 and the graph's operands fit 48 KB: the model's
//          path, synthetic2 [10,25,25], protein [50,50,50], mnist
//          [2,50,50]): one block per graph stages A (rows padded to an odd
//          stride), gy (formed from g and out as it is staged), X and W in
//          shared memory as f32, forms gxw in shared memory (one thread per
//          (k, column), four chains over i, reading A down its columns),
//          then gx (per (k, f)) and the graph's partial gW (per (f,
//          column)) from it.  W is always fused.
//   tiled  (every other shape): 64 x 64 tiles of gxw (rows k, columns h)
//          on CUDA cores, 256 threads of 4 x 4 outputs, i in steps of 32
//          through shared memory, the next step's A, g and out loaded
//          into registers while this one is summed (all the loads issued
//          before any is used; gy formed as the step is stored).
//          Offsets are 64-bit.  Where W is fused (F <= 16, as the
//          forward), a block walks every 64-column chunk of h for its k-tile,
//          keeping its gx outputs in registers across chunks and writing
//          the tile's partial gW of each chunk; otherwise the grid also
//          runs over column tiles and the kernel writes gxw, whose products
//          with W the wrapper forms as plain products (as the forward's
//          wide-F projection).
// The partial gW (one per graph, or per graph and k-tile) go to an f32
// workspace; every block then takes one atomic increment of a counter,
// and the block that takes the last one sums the partials in a fixed
// order, writes gW and resets the counter to 0 for the next launch on its
// stream.  Only the election is atomic; every float sum has a fixed order,
// so two calls are bit-equal.
//   dA     (a second launch, only when dL/dA is asked; no path asks today):
//          64 x 64 tiles of gA (rows i, columns k), h in steps of 32, gy
//          and xw staged transposed (xw = round_T(X @ W) recomputed in
//          shared memory where W is fused).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- sizes, mirrored by adj_matmul_backward_plan (adj_matmul.py) ----
constexpr int kThreads = 256;
constexpr int kSmallMax = 64, kSmallMaxSmem = 48 * 1024;
constexpr int kTk = 64, kTh = 64, kTi = 32;   // tiled: gxw tile rows k, columns h; i step
constexpr int kRed = kTh + 4;                 // row stride of the rounded gxw tile
constexpr int kDi = 64, kDk = 64, kDh = 32;   // dA: tile rows i, columns k; h step
constexpr int kDs = 64 + 4;                   // row stride of dA's transposed operands
constexpr int kMaxFusedF = 16;
constexpr int kPer = kTi * kTk / kThreads;    // elements of one i step each thread loads
static_assert(kTk == kTh && kTk == 16 * 4 && kDi == kDk && kDi == 16 * 4, "4 x 4 a thread");
static_assert(kDi * kDh / kThreads == 8, "dA: eight staged elements a thread");

// the gradients asked for, as bits of ``flags``
enum : int { kA = 1, kX = 2, kW = 4 };

__host__ __device__ constexpr int tiled_floats(int f) {
  return (2 * kTi * kTk > kTk * kRed ? 2 * kTi * kTk : kTk * kRed) + 2 * kTk * f;
}
__host__ __device__ constexpr int small_floats(int n, int m, int h, int f) {
  return n * (m | 1) + n * h + m * h + m * f + f * h;
}
__host__ __device__ constexpr int da_floats(int f) { return 2 * kDh * kDs + kDk * f + f * kDh; }

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

struct Args {
  const void *a, *x, *w, *out, *g;
  void *gx, *gw, *ga;     // gx: [B,m,f] where W is fused, else gxw [B,m,h]
  float* part;            // the partial gW, [parts][f*h]
  unsigned* counter;
  int batch, n, m, h, f;  // f = 0: no W in the kernel
  float leak;
  int has_leak, flags;
  int k_tiles, h_tiles;
};

// The sum of the partial gW over the grid: every block, its partials
// written and fenced, takes one atomic increment of the counter; the block
// that takes the last one sums part[parts][f*h] over parts in order,
// writes gW and resets the counter for the next launch on this stream.
template <typename T>
__device__ void finish_gw(const Args& p, int parts) {
  __shared__ bool last;
  __threadfence();   // this thread's partials, GPU-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.counter, 1u) == gridDim.x * gridDim.y * gridDim.z - 1u;
    if (last) __threadfence();   // acquire: the other blocks' partials
  }
  __syncthreads();
  if (!last) return;
  const int cols = p.f * p.h;
  T* gw = static_cast<T*>(p.gw);
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < parts; ++q) s += __ldcg(p.part + static_cast<int64_t>(q) * cols + c);
    gw[c] = from_f<T>(s);
  }
  if (threadIdx.x == 0) *p.counter = 0u;
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

// ---------------------------------------------------------------- tiled

// One i step of A [kTi][kTk], g and out [kTi][kTh] into registers: every
// load issued before any is used (a load inside act's branches would wait
// for the one before it), from a clamped address, A and g zeroed outside
// (gy = 0 there).
template <typename T>
struct Step {
  float a[kPer];
  T g[kPer], o[kPer];
};

template <typename T>
__device__ __forceinline__ void load_step(const T* a, const T* g, const T* o, const Args& p,
                                          int i0, int k0, int h0, Step<T>& r) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads, ii = idx / kTk, cc = idx % kTk;
    const int i = i0 + ii, k = k0 + cc, c = h0 + cc;
    const bool ok_a = i < p.n && k < p.m, ok_g = i < p.n && c < p.h;
    const int64_t row = ok_a || ok_g ? i : 0;
    const float av = to_f(a[ok_a ? row * p.m + k : 0]);
    const T gv = g[ok_g ? row * p.h + c : 0];
    r.o[e] = p.has_leak ? o[ok_g ? row * p.h + c : 0] : gv;
    r.a[e] = ok_a ? av : 0.f;
    r.g[e] = ok_g ? gv : from_f<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adj_bwd_tiled_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;   // rows 4tr.., columns 4tc..
  const int f = p.f, kt = blockIdx.x % p.k_tiles, k0 = kt * kTk;
  const int64_t b = blockIdx.y;
  float* as = smem;                      // A [kTi][kTk]
  float* gs = smem + kTi * kTk;          // gy [kTi][kTh]
  float* tile = smem;                    // gxw [kTk][kRed] after the i loop (aliases both)
  float* xs = smem + tiled_floats(0);    // X [kTk][f]
  float* ws = xs + kTk * f;              // W [f][kTh]
  const T* a = static_cast<const T*>(p.a) + b * p.n * p.m;
  const T* g = static_cast<const T*>(p.g) + b * p.n * p.h;
  const T* o = static_cast<const T*>(p.out) + b * p.n * p.h;
  T* gx = static_cast<T*>(p.gx);
  if (f) {
    const T* x = static_cast<const T*>(p.x) + b * p.m * f;
    for (int e = tid; e < kTk * f; e += kThreads) {
      const int k = k0 + e / f;
      xs[e] = k < p.m ? to_f(x[static_cast<int64_t>(k) * f + e % f]) : 0.f;
    }
  }
  constexpr int kOwn = kTk * kMaxFusedF / kThreads;   // gx outputs a thread owns (fused)
  float gxr[kOwn] = {};
  const int chunks = f ? p.h_tiles : 1;
  for (int ch = 0; ch < chunks; ++ch) {
    const int h0 = (f ? ch : static_cast<int>(blockIdx.x) / p.k_tiles) * kTh;
    float acc[4][4] = {};
    Step<T> next;
    load_step(a, g, o, p, 0, k0, h0, next);
    for (int i0 = 0; i0 < p.n; i0 += kTi) {
      __syncthreads();   // the last step's (or chunk's) reads of shared memory are done
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        as[tid + e * kThreads] = next.a[e];
        gs[tid + e * kThreads] = grad_y<T>(next.g[e], next.o[e], p.leak, p.has_leak);
      }
      __syncthreads();
      if (i0 + kTi < p.n) load_step(a, g, o, p, i0 + kTi, k0, h0, next);
#pragma unroll 8
      for (int ii = 0; ii < kTi; ++ii) {
        const float4 av = *reinterpret_cast<const float4*>(as + ii * kTk + 4 * tr);
        const float4 gv = *reinterpret_cast<const float4*>(gs + ii * kTh + 4 * tc);
        const float ar[4] = {av.x, av.y, av.z, av.w}, gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], gr[c], acc[r][c]);
      }
    }
    if (!f) {   // gxw, rounded to T
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 4 * tr + r;
        if (k >= p.m) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = h0 + 4 * tc + c;
          if (cc < p.h) gx[(b * p.m + k) * p.h + cc] = from_f<T>(acc[r][c]);
        }
      }
      return;
    }
    __syncthreads();   // the i loop's reads are done: the tile may overwrite them
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) tile[(4 * tr + r) * kRed + 4 * tc + c] = round_to<T>(acc[r][c]);
    const T* w = static_cast<const T*>(p.w);
    for (int e = tid; e < f * kTh; e += kThreads) {
      const int q = e / kTh, c = h0 + e % kTh;
      ws[e] = c < p.h ? to_f(w[q * p.h + c]) : 0.f;
    }
    __syncthreads();
    if (p.flags & kX) {   // gx[k, q] += sum over this chunk's columns of gxw[k, c] W[q, c]
#pragma unroll
      for (int u = 0; u < kOwn; ++u) {
        const int e = tid + u * kThreads;
        if (e >= kTk * f) break;
        const int k = e / f, q = e % f;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < kTh; c += 4)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            s[v] = fmaf(tile[k * kRed + c + v], ws[q * kTh + c + v], s[v]);
        gxr[u] += (s[0] + s[1]) + (s[2] + s[3]);
      }
    }
    if (p.flags & kW) {   // the tile's partial gW[q, c] over its rows k
      float* part = p.part + (b * p.k_tiles + kt) * static_cast<int64_t>(f) * p.h;
      for (int e = tid; e < f * kTh; e += kThreads) {
        const int q = e / kTh, c = e % kTh;
        if (h0 + c >= p.h) continue;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int k = 0; k < kTk; k += 4)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            s[v] = fmaf(xs[(k + v) * f + q], tile[(k + v) * kRed + c], s[v]);
        part[q * p.h + h0 + c] = (s[0] + s[1]) + (s[2] + s[3]);
      }
    }
  }
  if (p.flags & kX) {
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int e = tid + u * kThreads;
      if (e >= kTk * f) break;
      const int k = k0 + e / f;
      if (k < p.m) gx[(b * p.m + k) * f + e % f] = from_f<T>(gxr[u]);
    }
  }
  if (p.flags & kW) finish_gw<T>(p, p.batch * p.k_tiles);
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
    T gv[kPerD], ov[kPerD];   // every load issued before any is used, as load_step
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
      const float4 gv = *reinterpret_cast<const float4*>(gs + c * kDs + 4 * tr);
      const float4 xv = *reinterpret_cast<const float4*>(xws + c * kDs + 4 * tc);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w}, xr[4] = {xv.x, xv.y, xv.z, xv.w};
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
  int variant;       // 0 = small, 1 = tiled
  int fuse_w;        // W's products in the kernel
  int threads, smem;
  int grid[3];
  int k_tiles;       // tiled: 64-row tiles of k
  int h_tiles;       // tiled: 64-column tiles of h (walked by each block where W is fused)
  int parts;         // rows of the partial gW (0: gW not asked or not fused)
  int da_grid[3];    // the dA kernel (0s where dA is not asked)
  int da_smem;
};

namespace {

template <typename T>
int launch(const Args& p, const BackwardPlan& lp, cudaStream_t st) {
  const dim3 grid(lp.grid[0], lp.grid[1], lp.grid[2]);
  if (p.flags & (kX | kW)) {
    if (lp.variant == 0)
      adj_bwd_small_kernel<T><<<grid, lp.threads, lp.smem, st>>>(p);
    else
      adj_bwd_tiled_kernel<T><<<grid, lp.threads, lp.smem, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.flags & kA) {
    adj_bwd_da_kernel<T><<<dim3(lp.da_grid[0], lp.da_grid[1], lp.da_grid[2]), kThreads,
                           lp.da_smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

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
  // the small variant always fuses W, the tiled ones up to kMaxFusedF
  const bool small = n <= kSmallMax && m <= kSmallMax &&
                     4LL * small_floats(n, m, h, f) <= kSmallMaxSmem;
  if (fuse != (f > 0 && (small || f <= kMaxFusedF)) || lp.fuse_w != static_cast<int>(fuse) ||
      ((flags & kW) && !fuse) || lp.threads != kThreads)
    return bad;
  const int fk = fuse ? f : 0;
  const int64_t k_tiles = cdiv(m, kTk), h_tiles = cdiv(h, kTh);
  int64_t grid_x, smem, parts;
  if (small) {
    grid_x = batch;
    smem = 4LL * small_floats(n, m, h, fk);
    parts = (flags & kW) ? batch : 0;
    if (lp.variant != 0 || lp.k_tiles != 0 || lp.h_tiles != 0) return bad;
  } else {
    grid_x = k_tiles * (fuse ? 1 : h_tiles);
    smem = 4LL * tiled_floats(fk);
    parts = (flags & kW) ? static_cast<int64_t>(batch) * k_tiles : 0;
    if (lp.variant != 1 || lp.k_tiles != k_tiles || lp.h_tiles != h_tiles ||
        batch > 65535 || grid_x > 0x7fffffffLL)
      return bad;
  }
  const bool main_kernel = flags & (kX | kW);
  const int64_t da_x = (flags & kA) ? cdiv(n, kDi) * k_tiles : 0;
  if ((main_kernel && (lp.grid[0] != grid_x || lp.grid[1] != (small ? 1 : batch) ||
                       lp.grid[2] != 1 || lp.smem != smem)) ||
      lp.parts != parts || parts > 0x7fffffffLL ||
      ((flags & kA) && (lp.da_grid[0] != da_x || lp.da_grid[1] != batch ||
                        lp.da_grid[2] != 1 || lp.da_smem != 4LL * da_floats(fk) ||
                        batch > 65535 || da_x > 0x7fffffffLL)))
    return bad;
  if (!a || !g || (has_leak && !out) || ((flags & kX) && !gx) ||
      ((flags & kW) && (!gw || !part || !counter)) || ((flags & kA) && (!ga || !x)) ||
      (fuse && !x))
    return bad;
  const Args p{a, x, w, out, g, gx, gw, ga, part, counter, batch, n, m, h, fk, leak,
               has_leak, flags, small ? 0 : static_cast<int>(k_tiles),
               small ? 0 : static_cast<int>(h_tiles)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, lp, st) : launch<bf16>(p, lp, st);
}
