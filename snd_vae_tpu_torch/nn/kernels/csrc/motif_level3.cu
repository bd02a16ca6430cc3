// motif_level3: level 3 of the third-order spatial-motif conv, from phi(rel)
// to the masked j-sum, in the rank-R arithmetic of the JAX default path
// (snd_vae_tpu/nn/spatial_conv.py:220-238):
//
//   rf[b,i,j,r] = sum_k A[b,j,k] * phi[b,i,k,r]            (row j of A, row i of phi)
//   m3[b,i,j,:] = A[b,i,j] * ( deg[b,j] * (a_i[b,i,:] + bias + sum_r phi[b,i,j,r] * M1d[r,:])
//                              + v_j[b,j,:] + sum_r rf[b,i,j,r] * M1f[r,:] )
//   nt[b,i,:]   = sum_j A[b,i,j] * lrelu(m3[b,i,j,:]),   lrelu(x) = max(x, 0.2 x)
//
// with f32 accumulation, for f32 or bf16 tensors (nt has the inputs' dtype).
//
// A launch computes a window of rows i in [row0, row0 + n_rows): phi, a_i
// and nt hold those rows only ([B, n_rows, N, R], [B, n_rows, h]), while A,
// deg and v_j stay whole (rf reads row j of A for every j).  Under the
// mesh's model axis each rank launches its own window; the full launch is
// the window (0, N).
//
// It replaces, on the served path, the chain built around the TPU kernel
// fused_motif_combine (snd_vae_tpu/nn/pallas/blocked_spmm.py:204, ported as
// csrc/motif_combine.cu): the projections d_ij = phi @ M1d and
// f_ik = phi @ M1f, the combine, the lrelu and the masked j-sum.  No
// [B,N,N,h] tensor of that chain reaches device memory here.
//
// What bounds it on an H100.  Bytes: adj [B,N,N], phi [B,N,N,R], a_i, v_j
// and nt [B,N,h]: ~2.0 MB at the served shape (B = 100 trees, N = 25,
// h = 50, R = 1, f32), ~0.6 us at 3.35 TB/s.  Operations: the rf product is
// 2*B*N^3*R FLOP (3.1 MFLOP at the served shape, 134 MFLOP at B = 4,
// N = 256) and the epilogue 4R+7 FLOP per (i,j,h) with A[i,j] != 0 (at most
// ~34 MFLOP served, ~144 MFLOP at N = 256 dense): ~0.6 us and ~4.3 us at the
// 67 TFLOP/s of the f32 CUDA cores.  Both sit under one launch at the served
// shape, so the design is one launch with few round trips to memory.
//
// Design.  One block owns one tree b, a tile of kTi = 8 rows i (one warp
// each) and a 64-wide chunk of h, over all j.  Each lane keeps nt for its
// row and its two h columns in registers through the whole j loop, so the
// j-reduction needs no second pass and no atomics.  For each j-tile of 32:
//   1. rf for the (i-tile, j-tile): k-chunks of A[b, j-tile, :] and
//      phi[b, i-tile, :, :] stream through shared memory, double-buffered
//      with cp.async, zero-filled past N: in 16-byte pieces where
//      N % 4 == 0 (N = 256), in 4-byte pieces otherwise.  At N = 25 a row
//      of A is 100 B, not a multiple of 16, so neither TMA nor 16-byte
//      pieces apply there; bf16 tiles go through registers (cp.async has no
//      2-byte piece) and are widened to f32 on the way in.  The j-tile's
//      epilogue operands (phi[b, i-tile, j-tile], A[b, i-tile, j-tile],
//      deg, v_j) ride in the first chunk's copy group, so a tile costs one
//      wait on memory, not two.  Thread (i, j) owns rf[i, j, :] and sums it
//      over k with FFMA into four partial sums (the chains overlap), reading
//      A four k at a time (float4; rows padded to kTk + 4 floats keep both
//      the 16-byte alignment and distinct banks) and phi, the same row for
//      the whole warp, as a broadcast.
//   2. The epilogue: a ballot over the tile's row of A lists the j with
//      A[i,j] != 0 (m3 is 0 elsewhere and lrelu(0) = 0; the served spanning
//      trees are ~8% dense), and warp i takes them two at a time, so the
//      loads of two pairs overlap.  A half-warp's 32 h columns past h are
//      skipped (h = 20 uses one of the two).
// The block's time is a chain of waits on memory, so the design keeps the
// chain short: at N <= 32 k-chunks are 32 wide and one j-tile and one
// k-chunk cover the tree (A[b], phi[b, i-tile], v_j[b], deg[b], M1d, M1f and
// the bias all sit in shared memory, one pass computes rf, m3 and nt, and
// the grid is B * ceil(N/8) * ceil(h/64) blocks: 400 at the served
// B*S = 100).  Larger N takes k-chunks 128 wide (N = 256: 2 per j-tile, 16
// in all) and walks the j-tiles.  Only R is capped, by shared memory:
// 18.6 KB + 4.6 KB per channel at the narrow chunks, 43.1 KB + 10.8 KB per
// channel at the wide ones (53.9 KB at R = 1), of the 227 KB a block may take,
// so R <= 17 at N > 32; beyond, the launch returns cudaErrorInvalidValue.
// h > 64 recomputes rf for each h chunk.  Ragged N and h are masked, not
// padded.
// No tensor cores: after the rank-R fold the product is only R deep per
// (i,j), TF32 would break the 1e-5 check against the plain version, and the
// f32 CUDA cores do the 134 MFLOP at N = 256 in ~2 us.
#include "motif_level3.cuh"

namespace {

template <typename T, int kTk>
__global__ void __launch_bounds__(kThreads)
motif_level3_kernel(const T* __restrict__ adj, const T* __restrict__ phi,
                    const T* __restrict__ a_i, const T* __restrict__ v_j,
                    const T* __restrict__ deg, const T* __restrict__ m1d,
                    const T* __restrict__ m1f, const T* __restrict__ bias,
                    T* __restrict__ nt, int n, int row0, int rows, int r, int h,
                    int n_i_tiles, int n_h_tiles, bool vec) {
  // one A tile; rows padded by 4 floats keep 16-byte alignment, and a
  // quarter-warp's float4 reads of 8 rows then fall on distinct banks
  constexpr int kAp = kTk + 4, kAs = kTj * kAp;
  extern __shared__ float smem[];
  float* as = smem;                     // [2][kTj][kTk+4]  A[b, j-tile, k-chunk]
  float* ps = as + 2 * kAs;             // [2][kTi][kTk][r] phi[b, i-tile, k-chunk, :]
  float* rfs = ps + 2 * kTi * kTk * r;  // [kTi][kTj][r]    rf[b, i-tile, j-tile, :]
  float* pj = rfs + kTi * kTj * r;      // [kTi][kTj][r]    phi[b, i-tile, j-tile, :]
  float* mk = pj + kTi * kTj * r;       // [kTi][kTj]       A[b, i-tile, j-tile]
  float* dg = mk + kTi * kTj;           // [kTj]            deg[b, j-tile]
  float* vs = dg + kTj;                 // [kTj][kHc]       v_j[b, j-tile, h-chunk]
  float* wd = vs + kTj * kHc;           // [r][kHc]         M1d[:, h-chunk]
  float* wf = wd + r * kHc;             // [r][kHc]         M1f[:, h-chunk]

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  int64_t blk = blockIdx.x;
  const int hc0 = static_cast<int>(blk % n_h_tiles) * kHc;
  blk /= n_h_tiles;
  const int i0 = static_cast<int>(blk % n_i_tiles) * kTi;
  const int64_t b = blk / n_i_tiles;
  const int i = i0 + w;                 // this warp's row of the window
  const T* ab = adj + b * n * n;        // A[b]   [n, n]
  const T* pb = phi + b * rows * n * r; // phi[b] [rows, n, r]
  const T* mb = ab + static_cast<int64_t>(row0) * n;   // A[b, row0:, :], the mask rows

  stage_m1(wd, wf, m1d, m1f, r, h, hc0);   // joins the first tile's copy group
  float base[kHl], acc[kHl];            // a_i + bias, and nt, for (i, h)
#pragma unroll
  for (int q = 0; q < kHl; ++q) {
    const int hh = hc0 + lane + 32 * q;
    base[q] = (i < rows && hh < h) ? to_f(a_i[(b * rows + i) * h + hh]) + to_f(bias[hh]) : 0.f;
    acc[q] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += kTj) {
    __syncthreads();                    // the last j-tile's epilogue is done with the tiles
    stage_tile(pj, mk, dg, vs, pb, mb, deg, v_j, b, n, rows, r, h, i0, j0, hc0);
    // 1. rf[i, j0 + lane, :] for this thread, k-chunk by k-chunk
    rf_tile<kTk>(as, ps, rfs, ab, pb, n, rows, r, i0, j0, vec);

    // 2. m3, lrelu and the masked j-sum for row i, over the j with
    // A[i,j] != 0 only (a ballot lists them), two j at a time
    if (i < rows) {
      const unsigned all = 0xffffffffu;
      const float a_l = mk[w * kTj + lane], d_l = dg[lane];   // A[i, j0+lane], deg[j0+lane]
      float wd0[kHl], wf0[kHl];                                // channel 0 of M1d, M1f
#pragma unroll
      for (int q = 0; q < kHl; ++q) {
        wd0[q] = r > 0 ? wd[lane + 32 * q] : 0.f;
        wf0[q] = r > 0 ? wf[lane + 32 * q] : 0.f;
      }
      // lrelu(m3[i, j0+jj, hh]) for the lane's column q
      auto lrelu_m3 = [&](int jj, float aij, float dj, int q) {
        const int hh = lane + 32 * q;
        const float* pr = pj + (w * kTj + jj) * r;
        const float* fr = rfs + (w * kTj + jj) * r;
        float sd = base[q], sf = vs[jj * kHc + hh];
        if (r > 0) {
          sd = fmaf(pr[0], wd0[q], sd);
          sf = fmaf(fr[0], wf0[q], sf);
        }
        for (int rr = 1; rr < r; ++rr) {
          sd = fmaf(pr[rr], wd[rr * kHc + hh], sd);
          sf = fmaf(fr[rr], wf[rr * kHc + hh], sf);
        }
        const float m = aij * fmaf(dj, sd, sf);
        return fmaxf(m, kLeak * m);
      };
      unsigned live = __ballot_sync(all, a_l != 0.f);
      while (live) {                    // warp-uniform
        const int j1 = __ffs(live) - 1;
        live &= live - 1;
        const bool two = live != 0;
        const int j2 = two ? __ffs(live) - 1 : j1;
        if (two) live &= live - 1;
        const float a1 = __shfl_sync(all, a_l, j1), d1 = __shfl_sync(all, d_l, j1);
        const float a2 = __shfl_sync(all, a_l, j2), d2 = __shfl_sync(all, d_l, j2);
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          if (hc0 + 32 * q >= h) break;  // warp-uniform: no column of this half is live
          const float l1 = lrelu_m3(j1, a1, d1, q), l2 = lrelu_m3(j2, a2, d2, q);
          acc[q] = fmaf(a1, l1, acc[q]);
          if (two) acc[q] = fmaf(a2, l2, acc[q]);
        }
      }
    }
  }
  if (i >= rows) return;
#pragma unroll
  for (int q = 0; q < kHl; ++q) {
    const int hh = hc0 + lane + 32 * q;
    if (hh < h) nt[(b * rows + i) * h + hh] = from_f<T>(acc[q]);
  }
}

template <typename T, int kTk>
int launch(const void* adj, const void* phi, const void* a_i, const void* v_j,
           const void* deg, const void* m1d, const void* m1f, const void* bias, void* nt,
           int batch, int n, int row0, int rows, int r, int h, void* stream) {
  const int n_i_tiles = (rows + kTi - 1) / kTi;
  const int n_h_tiles = (h + kHc - 1) / kHc;
  const int64_t blocks = static_cast<int64_t>(batch) * n_i_tiles * n_h_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(float) * smem_floats<kTk>(r);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = std::is_same<T, float>::value && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(adj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(phi) % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        motif_level3_kernel<T, kTk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  motif_level3_kernel<T, kTk><<<static_cast<unsigned>(blocks), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(adj), static_cast<const T*>(phi), static_cast<const T*>(a_i),
      static_cast<const T*>(v_j), static_cast<const T*>(deg), static_cast<const T*>(m1d),
      static_cast<const T*>(m1f), static_cast<const T*>(bias), static_cast<T*>(nt), n, row0,
      rows, r, h, n_i_tiles, n_h_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

// k-chunks 32 wide where one covers the tree, 128 wide beyond
template <typename T>
int launch(const void* adj, const void* phi, const void* a_i, const void* v_j,
           const void* deg, const void* m1d, const void* m1f, const void* bias, void* nt,
           int batch, int n, int row0, int rows, int r, int h, void* stream) {
  if (row0 < 0 || rows < 0 || row0 + rows > n) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || rows == 0 || h == 0) return 0;
  return n <= 32 ? launch<T, 32>(adj, phi, a_i, v_j, deg, m1d, m1f, bias, nt, batch, n, row0,
                                 rows, r, h, stream)
                 : launch<T, 128>(adj, phi, a_i, v_j, deg, m1d, m1f, bias, nt, batch, n, row0,
                                  rows, r, h, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous: adj [B,N,N],
// phi [B,rows,N,R], a_i [B,rows,H], v_j [B,N,H], deg [B,N], m1d [R,H],
// m1f [R,H], bias [H], nt [B,rows,H] for the window of rows
// [row0, row0 + rows) of N; their strides follow from the shapes.
extern "C" int motif_level3_launch(const void* adj, const void* phi, const void* a_i,
                                   const void* v_j, const void* deg, const void* m1d,
                                   const void* m1f, const void* bias, void* nt, int batch,
                                   int n, int row0, int rows, int r, int h, int dtype,
                                   void* stream) {
  if (dtype == 0)
    return launch<float>(adj, phi, a_i, v_j, deg, m1d, m1f, bias, nt, batch, n, row0, rows, r,
                         h, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(adj, phi, a_i, v_j, deg, m1d, m1f, bias, nt, batch, n, row0,
                                 rows, r, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
