// motif_combine: level 3 of the third-order spatial-motif conv,
//
//   out[b,i,j,:] = A[b,i,j] * ( deg[b,j] * (a_i[b,i,:] + d_ij[b,i,j,:] + bias)
//                               + v_j[b,j,:] + sum_k A[b,j,k] * f_ik[b,i,k,:] )
//   deg[b,j] = sum_k A[b,j,k]
//
// with f32 accumulation, for f32 or bf16 tensors (out has f_ik's dtype).
//
// Replaces the TPU kernel fused_motif_combine (snd_vae_tpu/nn/pallas/
// blocked_spmm.py:204, body _motif_kernel :162), which pads N and h to the
// 128-lane tile and keeps one i-tile of every operand in VMEM.  Note the
// indices: deg is indexed by j, the contraction uses row j of A
// (wf[b,i] = A[b] @ f_ik[b,i]) and the mask is row i of A.
//
// What bounds it on an H100: bytes.  d_ij, f_ik and out are each
// B*N*N*h elements and dominate the traffic; the contraction is
// 2*B*N^3*h FLOP, ~N/6 FLOP per byte at f32, well under the card's
// balance point for the served N = 25.  The design therefore reads each
// d_ij / out element once, coalesced along h, and stages the reused
// operands (a 32x32 tile of A and a 32-row chunk of f_ik[b,i]) in shared
// memory k-chunk by k-chunk, so N is not capped by shared memory.
// One block owns a 32(j) x 32(h) tile of out[b,i]; 256 threads each hold
// 4 (j) accumulators of the sum over k and the matching partial degrees,
// so deg needs no separate pass.  Ragged N and h are masked on load and
// store instead of padded.  The served path no longer runs this kernel:
// csrc/motif_level3.cu takes phi(rel), M1d and M1f in place of d_ij and
// f_ik and fuses on through lrelu and the masked j-sum.  This one stays as
// the literal counterpart of the TPU kernel.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // j rows = h lanes = k chunk per block
constexpr int kRows = 8;    // thread rows; each thread owns kTile/kRows j rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
motif_combine_kernel(const T* __restrict__ adj, const T* __restrict__ a_i,
                     const T* __restrict__ d_ij, const T* __restrict__ v_j,
                     const T* __restrict__ f_ik, const T* __restrict__ bias,
                     T* __restrict__ out, int n, int h, int n_h_tiles, int n_j_tiles) {
  __shared__ float as[kTile][kTile + 1];   // A[b, j-tile, k-chunk]
  __shared__ float fs[kTile][kTile + 1];   // f_ik[b, i, k-chunk, h-tile]
  const int tx = threadIdx.x, ty = threadIdx.y;
  int64_t blk = blockIdx.x;
  const int h0 = static_cast<int>(blk % n_h_tiles) * kTile;
  blk /= n_h_tiles;
  const int j0 = static_cast<int>(blk % n_j_tiles) * kTile;
  blk /= n_j_tiles;
  const int i = static_cast<int>(blk % n);
  const int64_t b = blk / n;

  const T* ab = adj + b * n * n;                   // A[b]      [n, n]
  const T* fb = f_ik + (b * n + i) * n * h;        // f_ik[b,i] [n, h]

  float acc[kTile / kRows], deg[kTile / kRows];
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) acc[q] = deg[q] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int r = ty; r < kTile; r += kRows) {
      const int j = j0 + r, k = k0 + tx;
      as[r][tx] = (j < n && k < n) ? to_f(ab[static_cast<int64_t>(j) * n + k]) : 0.f;
      const int kf = k0 + r, hh = h0 + tx;
      fs[r][tx] = (kf < n && hh < h) ? to_f(fb[static_cast<int64_t>(kf) * h + hh]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float fv = fs[kk][tx];
#pragma unroll
      for (int q = 0; q < kTile / kRows; ++q) {
        const float av = as[ty + kRows * q][kk];
        acc[q] = fmaf(av, fv, acc[q]);
        deg[q] += av;
      }
    }
    __syncthreads();
  }

  const int hh = h0 + tx;
  if (hh >= h) return;
  const float base = to_f(a_i[(b * n + i) * h + hh]) + to_f(bias[hh]);
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) {
    const int j = j0 + ty + kRows * q;
    if (j >= n) continue;
    const int64_t pij = (b * n + i) * n + j;       // flat (b, i, j)
    const float mask = to_f(adj[pij]);             // A[b,i,j]
    const float comb = deg[q] * (base + to_f(d_ij[pij * h + hh]))
                     + to_f(v_j[(b * n + j) * h + hh]) + acc[q];
    out[pij * h + hh] = from_f<T>(mask * comb);
  }
}

template <typename T>
int launch(const void* adj, const void* a_i, const void* d_ij, const void* v_j,
           const void* f_ik, const void* bias, void* out, int batch, int n, int h,
           void* stream) {
  if (batch == 0 || n == 0 || h == 0) return 0;
  const int n_h_tiles = (h + kTile - 1) / kTile;
  const int n_j_tiles = (n + kTile - 1) / kTile;
  const int64_t blocks = static_cast<int64_t>(batch) * n * n_j_tiles * n_h_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  motif_combine_kernel<T><<<static_cast<unsigned>(blocks), dim3(kTile, kRows), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(adj), static_cast<const T*>(a_i), static_cast<const T*>(d_ij),
      static_cast<const T*>(v_j), static_cast<const T*>(f_ik), static_cast<const T*>(bias),
      static_cast<T*>(out), n, h, n_h_tiles, n_j_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous:
// adj [B,N,N], a_i [B,N,H], d_ij [B,N,N,H], v_j [B,N,H], f_ik [B,N,N,H],
// bias [H], out [B,N,N,H]; their strides follow from the shapes.
extern "C" int motif_combine_launch(const void* adj, const void* a_i, const void* d_ij,
                                    const void* v_j, const void* f_ik, const void* bias,
                                    void* out, int batch, int n, int h, int dtype,
                                    void* stream) {
  if (dtype == 0)
    return launch<float>(adj, a_i, d_ij, v_j, f_ik, bias, out, batch, n, h, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(adj, a_i, d_ij, v_j, f_ik, bias, out, batch, n, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
