// Shared by motif_level4.cu (level 4 of the fourth-order motif conv and its
// masked k-sum) and motif_level4_backward.cu (its gradient): one warp owns
// one output row, a lane one column h, and the neighbours come from ballots
// over rows (or columns) of the masks, 32 at a time.  Each translation unit
// takes its own copy (an anonymous namespace).
//
// The element of level 4 both kernels recompute, with the plain chain's
// roundings (each product and sum rounded on its own, as PyTorch's
// element-wise ops round them, so no FMA contracts them):
//
//   c = ((deg[k] * pu[i,j,h] + alpha[i,k,h]) + beta[j,k,h]) + gamma[k,h]
//   z = c * (M[i,j] * M[j,k])
//
// All offsets are 64-bit: mnist's layer 2 at larger N passes 2^31 elements.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps per block, one output row each
constexpr int kThreads = 32 * kWarps;
constexpr float kLeak = 0.2f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Lane l reads entry c0 + l of a row of n entries spaced ``stride`` apart
// (0 past n) into *v; returns the ballot of the entries that are not 0.
template <typename T>
__device__ __forceinline__ unsigned live_of(const T* row, int64_t stride, int c0, int n,
                                            int lane, float* v) {
  const int c = c0 + lane;
  *v = c < n ? to_f(row[c * stride]) : 0.f;
  return __ballot_sync(kAll, *v != 0.f);
}

// z of one (i,j,k,h), as the module comment gives it.
__device__ __forceinline__ float level4_z(float dk, float p, float al, float be, float ga,
                                          float mm) {
  const float c = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dk, p), al), be), ga);
  return __fmul_rn(c, mm);
}

// Writes 0 to the entries c of [c0, min(c0 + 32, n)) of an [n, h] row that
// ``live`` does not list (bit c - c0), all h columns of each, the warp's
// lanes on consecutive addresses.
template <typename T>
__device__ __forceinline__ void zero_dead(T* row, int c0, int n, int h, unsigned live,
                                          int lane) {
  const int c1 = min(c0 + 32, n);
  T* base = row + static_cast<int64_t>(c0) * h;
  const int len = (c1 - c0) * h;
  for (int e = lane; e < len; e += 32) {
    if (!((live >> (e / h)) & 1u)) base[e] = from_f<T>(0.f);
  }
}

}  // namespace
