// Shared by motif_level3.cu (level 3 of the third-order motif conv) and
// motif_level3_backward.cu (its gradient): the tile constants, the staging
// of tiles into shared memory with cp.async, and the recompute of rf for
// one (i-tile, j-tile), k-chunk by k-chunk, double-buffered.  Each
// translation unit takes its own copy (an anonymous namespace).
#pragma once
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTi = 8;                 // rows i per block, one warp each
constexpr int kTj = 32;                // j per tile, one lane each in the rf step
constexpr int kHl = 2;                 // h columns per lane
constexpr int kHc = 32 * kHl;          // h columns per block
constexpr int kThreads = 32 * kTi;
constexpr float kLeak = 0.2f;
constexpr size_t kMaxSmem = 232448;    // what one block may take on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One element into shared memory: f32 by cp.async (src-size 0 zero-fills
// and reads nothing), bf16 through a register.
__device__ __forceinline__ void stage(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}
__device__ __forceinline__ void stage16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// k-chunk [k0, k0+kTk) of A[b, j-tile, :] into as [kTj][kTk+4] and of
// phi[b, i-tile, :, :] into ps [kTi][kTk*r] (i counts the window's rows,
// ``rows`` of them).  Invalid pieces read from the base pointer with
// src-size 0.  ``vec`` (f32, N % 4 == 0, 16-byte aligned
// tensors): 16-byte pieces, none of which straddles N.
template <int kTk, typename T>
__device__ __forceinline__ void stage_chunk(float* as, float* ps, const T* ab, const T* pb,
                                            int n, int rows, int r, int i0, int j0, int k0,
                                            bool vec) {
  constexpr int kAp = kTk + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = threadIdx.x; e < kTj * kTk / 4; e += kThreads) {
        const int jj = e / (kTk / 4), kk = 4 * (e % (kTk / 4)), j = j0 + jj, k = k0 + kk;
        const bool ok = j < n && k < n;
        stage16(as + jj * kAp + kk, ab + (ok ? static_cast<int64_t>(j) * n + k : 0), ok);
      }
      const int row = kTk * r / 4;
      for (int e = threadIdx.x; e < kTi * row; e += kThreads) {
        const int ii = e / row, q = 4 * (e % row), i = i0 + ii, k = k0 + q / r;
        const bool ok = i < rows && k < n;
        stage16(ps + ii * kTk * r + q,
                pb + (ok ? (static_cast<int64_t>(i) * n + k0) * r + q : 0), ok);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < kTj * kTk; e += kThreads) {
    const int jj = e / kTk, kk = e % kTk, j = j0 + jj, k = k0 + kk;
    const bool ok = j < n && k < n;
    stage(as + jj * kAp + kk, ab + (ok ? static_cast<int64_t>(j) * n + k : 0), ok);
  }
  const int row = kTk * r;
  for (int e = threadIdx.x; e < kTi * row; e += kThreads) {
    const int ii = e / row, q = e % row, i = i0 + ii, k = k0 + q / r;
    const bool ok = i < rows && k < n;
    stage(ps + e, pb + (ok ? (static_cast<int64_t>(i) * n + k0) * r + q : 0), ok);
  }
}

// The (i-tile, j-tile)'s operands besides rf, into shared memory (they join
// the copy group of rf's first k-chunk): phi[b, i-tile, j-tile, :] into
// pj [kTi][kTj][r], A[b, row0 + i-tile, j-tile] into mk [kTi][kTj], deg into
// dg [kTj] and v_j[b, j-tile, h-chunk] into vs [kTj][kHcT]; zero past the
// window's rows, N and h.  kHcT: the h chunk (the forward's kHc, or 32 for
// the backward where h <= 32).
template <int kHcT = kHc, typename T>
__device__ __forceinline__ void stage_tile(float* pj, float* mk, float* dg, float* vs,
                                           const T* pb, const T* mb, const T* deg,
                                           const T* v_j, int64_t b, int n, int rows, int r,
                                           int h, int i0, int j0, int hc0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kTi * kTj * r; e += kThreads) {
    const int ii = i0 + e / (kTj * r), q = e % (kTj * r);
    const bool ok = ii < rows && j0 + q / r < n;
    stage(pj + e, pb + (ok ? (static_cast<int64_t>(ii) * n + j0) * r + q : 0), ok);
  }
  for (int e = tid; e < kTi * kTj; e += kThreads) {
    const int ii = i0 + e / kTj, j = j0 + e % kTj;
    const bool ok = ii < rows && j < n;
    stage(mk + e, mb + (ok ? static_cast<int64_t>(ii) * n + j : 0), ok);
  }
  for (int e = tid; e < kTj; e += kThreads) {
    const bool ok = j0 + e < n;
    stage(dg + e, deg + (ok ? b * n + j0 + e : 0), ok);
  }
  for (int e = tid; e < kTj * kHcT; e += kThreads) {
    const int j = j0 + e / kHcT, hh = hc0 + e % kHcT;
    const bool ok = j < n && hh < h;
    stage(vs + e, v_j + (ok ? (b * n + j) * h + hh : 0), ok);
  }
}

// M1d[:, h-chunk] and M1f[:, h-chunk] into wd, wf [r][kHcT], zero past h.
template <int kHcT = kHc, typename T>
__device__ __forceinline__ void stage_m1(float* wd, float* wf, const T* m1d, const T* m1f,
                                         int r, int h, int hc0) {
  for (int e = threadIdx.x; e < r * kHcT; e += kThreads) {
    const int rr = e / kHcT, hh = hc0 + e % kHcT;
    stage(wd + e, m1d + (hh < h ? rr * h + hh : 0), hh < h);
    stage(wf + e, m1f + (hh < h ? rr * h + hh : 0), hh < h);
  }
}

// rf[b, i0 + w, j0 + lane, :] into rfs [kTi][kTj][r] for thread (w, lane):
// k-chunks of A[b, j-tile, :] and phi[b, i-tile, :, :] stream through as
// [2][kTj][kTk+4] and ps [2][kTi][kTk][r], double-buffered with cp.async
// (copies issued before the call join the first chunk's group).  Thread
// (i, j) sums over k with FFMA into four partial sums (the chains overlap),
// reading A four k at a time (float4; rows padded to kTk + 4 floats keep
// both the 16-byte alignment and distinct banks) and phi, the same row for
// the whole warp, as a broadcast.  Ends with a __syncthreads: rfs and every
// staged operand are then visible, and as and ps are free.
template <int kTk, typename T>
__device__ __forceinline__ void rf_tile(float* as, float* ps, float* rfs, const T* ab,
                                        const T* pb, int n, int rows, int r, int i0, int j0,
                                        bool vec) {
  constexpr int kAp = kTk + 4, kAs = kTj * kAp;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int rr = 0; rr < r; ++rr) rfs[(w * kTj + lane) * r + rr] = 0.f;
  const int nk = (n + kTk - 1) / kTk;
  stage_chunk<kTk>(as, ps, ab, pb, n, rows, r, i0, j0, 0, vec);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {                   // the next chunk's copies fly during this one's sums
      const int nb = (c + 1) & 1;
      stage_chunk<kTk>(as + nb * kAs, ps + nb * kTi * kTk * r, ab, pb, n, rows, r, i0, j0,
                       (c + 1) * kTk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // four k per float4 read of A; phi's row is the same for the whole
    // warp (a broadcast), read four k at a time where R = 1
    const float* at = as + (c & 1) * kAs + lane * kAp;
    const float* pt = ps + (c & 1) * kTi * kTk * r + w * kTk * r;
    for (int rr = 0; rr < r; ++rr) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTk; kk += 4) {
        const float4 a = *reinterpret_cast<const float4*>(at + kk);
        const float4 p = r == 1 ? *reinterpret_cast<const float4*>(pt + kk)
                                : make_float4(pt[kk * r + rr], pt[(kk + 1) * r + rr],
                                              pt[(kk + 2) * r + rr], pt[(kk + 3) * r + rr]);
        s0 = fmaf(a.x, p.x, s0);
        s1 = fmaf(a.y, p.y, s1);
        s2 = fmaf(a.z, p.z, s2);
        s3 = fmaf(a.w, p.w, s3);
      }
      rfs[(w * kTj + lane) * r + rr] += (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
  }
}

// Shared memory of one block, in floats: the forward's layout, which the
// backward begins with (its per-(i, j) sums alias the k-chunk buffers).
template <int kTk, int kHcT = kHc>
constexpr size_t smem_floats(int r) {
  return 2 * kTj * (kTk + 4) + 2 * kTi * kTk * r + 2 * kTi * kTj * r + kTi * kTj + kTj +
         kTj * kHcT + 2 * r * kHcT;
}

}  // namespace
