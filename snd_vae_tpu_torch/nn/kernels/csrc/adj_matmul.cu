// adj_matmul: out[b] = act(A[b] @ X[b]), act = identity or leaky ReLU
// max(x, leak*x), f32 accumulation, for f32 or bf16 tensors.
//
// Replaces the TPU kernel blocked_adj_matmul (snd_vae_tpu/nn/pallas/
// blocked_spmm.py:89, body _adj_matmul_kernel :66), which tiles A and X
// through VMEM on an (i, j, k) grid and carries the f32 sum in scratch from
// one k step to the next.  Here each block owns one 32x32 output tile and
// walks k in a loop of its own: nothing carries over between blocks.
//
// What bounds it on an H100: at the served shapes ([10,25,25]@[10,25,H],
// H = 10 and 20) the work is ~65 KB and a few hundred kFLOP, far below one
// launch's overhead, so the launch itself bounds it.  At the large-graph
// shape [2048,2048]@[2048,128] it is a plain f32 GEMM on CUDA cores.
// The design is the simple, right one: 32x32 tiles of A and X staged in
// shared memory (+1 column of padding against bank conflicts), 256 threads
// each holding 4 f32 accumulators, ragged edges masked on load and store,
// the lrelu applied to the f32 sum before the single store.  Tensor cores
// (wgmma) and a deeper pipeline are left to a later change.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // output rows = output cols = k chunk
constexpr int kRows = 8;    // thread rows; each thread owns kTile/kRows rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
adj_matmul_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ out,
                  int n, int m, int h, int64_t a_bstride, int64_t x_bstride,
                  int64_t o_bstride, int n_col_tiles, int n_row_tiles, float leak,
                  int has_leak) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float xs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  int64_t blk = blockIdx.x;
  const int col0 = static_cast<int>(blk % n_col_tiles) * kTile;
  blk /= n_col_tiles;
  const int row0 = static_cast<int>(blk % n_row_tiles) * kTile;
  const int64_t b = blk / n_row_tiles;
  const T* ab = a + b * a_bstride;
  const T* xb = x + b * x_bstride;

  float acc[kTile / kRows];
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kTile) {
    for (int r = ty; r < kTile; r += kRows) {
      const int ar = row0 + r, ak = k0 + tx;
      as[r][tx] = (ar < n && ak < m) ? to_f(ab[static_cast<int64_t>(ar) * m + ak]) : 0.f;
      const int xk = k0 + r, xc = col0 + tx;
      xs[r][tx] = (xk < m && xc < h) ? to_f(xb[static_cast<int64_t>(xk) * h + xc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float xv = xs[kk][tx];
#pragma unroll
      for (int q = 0; q < kTile / kRows; ++q) acc[q] = fmaf(as[ty + kRows * q][kk], xv, acc[q]);
    }
    __syncthreads();
  }

  const int c = col0 + tx;
  if (c >= h) return;
  T* ob = out + b * o_bstride;
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) {
    const int r = row0 + ty + kRows * q;
    if (r >= n) continue;
    float v = acc[q];
    if (has_leak) v = fmaxf(v, leak * v);
    ob[static_cast<int64_t>(r) * h + c] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* a, const void* x, void* out, int batch, int n, int m, int h,
           int64_t a_bstride, int64_t x_bstride, int64_t o_bstride, float leak,
           int has_leak, void* stream) {
  if (batch == 0 || n == 0 || h == 0) return 0;
  const int n_col_tiles = (h + kTile - 1) / kTile;
  const int n_row_tiles = (n + kTile - 1) / kTile;
  const int64_t blocks = static_cast<int64_t>(batch) * n_row_tiles * n_col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  adj_matmul_kernel<T><<<static_cast<unsigned>(blocks), dim3(kTile, kRows), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(out), n, m, h,
      a_bstride, x_bstride, o_bstride, n_col_tiles, n_row_tiles, leak, has_leak);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Inner two axes of a, x and out are
// contiguous; *_bstride are the element strides of the batch axis.
extern "C" int adj_matmul_launch(const void* a, const void* x, void* out, int batch, int n,
                                 int m, int h, int64_t a_bstride, int64_t x_bstride,
                                 int64_t o_bstride, float leak, int has_leak, int dtype,
                                 void* stream) {
  if (dtype == 0)
    return launch<float>(a, x, out, batch, n, m, h, a_bstride, x_bstride, o_bstride, leak,
                         has_leak, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, x, out, batch, n, m, h, a_bstride, x_bstride, o_bstride,
                                 leak, has_leak, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
