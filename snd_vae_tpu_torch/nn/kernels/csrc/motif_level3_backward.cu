// motif_level3_backward: the gradient of motif_level3 (csrc/motif_level3.cu)
// for g = dL/dnt, in two launches.  With c[i,j,:] the bracket of m3 (so
// m3 = A[i,j] c), e = a_i + bias + sum_r phi M1d its deg side, and
// lrelu'(x) = 1 for x > 0, 0.2 otherwise:
//
//   P[i,j,:]  = g[i] * A[i,j]^2 * lrelu'(m3[i,j,:])
//   da_i[i]   = sum_j deg[j] P[i,j]          dv_j[j] = sum_i P[i,j]
//   ddeg[j]   = sum_{i,h} P[i,j,h] e[i,j,h]  dbias   = sum deg P
//   dM1d      = sum phi (x) deg P            dM1f    = sum rf (x) P
//   gd, grf   = (deg P) M1d^T, P M1f^T                            [B,n,N,R]
//   dphi[i,k] = gd[i,k] + sum_j A[j,k] grf[i,j]
//   dA[j,k]   = sum_{i,r} grf[i,j,r] phi[i,k,r]
//               + on the window's rows i: sum_h g lrelu(m3) + A sum_h lrelu'(m3) g c
//
// for a window of rows i in [row0, row0 + rows), as the forward takes it.
// Only the gradients the flags ask for are computed and written; the
// model's path asks for a_i, v_j, M1d, M1f and the bias (A, phi(rel) and
// deg are data there).
//
// It replaces the backward of the TPU custom VJP motif_combine
// (snd_vae_tpu/nn/pallas/blocked_spmm.py:295, _motif_bwd: jax.vjp of the
// reference formula), which the port ran as autograd through the plain
// level 3: about thirty small ops per layer, holding the [B,n,N,h] tensors
// m3, d_ij and wf.  Neither kernel here writes a [B,n,N,h] tensor.
//
// What bounds it on an H100.  Bytes: A, phi, a_i, v_j, deg and g read, the
// asked-for gradients written: ~2.3 MB per layer at the served shape
// (B = 100 trees, N = 25, h = 50, R = 1, f32), ~0.7 us at 3.35 TB/s.
// Operations: rf's recompute (2R FLOP per (i,j,k) with A[i,j] != 0 and
// A[j,k] != 0) and ~8R + 11 FLOP per (i,j,h) with A[i,j] != 0 on the
// model's path; the served spanning trees are ~8% dense, so a few MFLOP, a
// fraction of a microsecond on the f32 CUDA cores.  chip_smoke.py's
// level3_backward_bound counts both from the batch's trees.  So, like the
// forward, it is bound by a chain of dependent waits on memory, not by
// bytes or operations, and the design keeps the chain short: one pass over
// the tiles, everything per (i, j, h) in registers, two launches.
//
// Kernel 1 (motif_l3_grad_rows_kernel): one block per (tree b, tile of
// kTi = 8 rows i), 8 warps, one row each, over all j and h.  For each
// j-tile of 32 it recomputes rf exactly as the forward does (the shared
// rf_tile: k-chunks of A and phi through shared memory, double-buffered
// with cp.async, the tile's other operands in the first chunk's copy
// group), then
//   A. warp i walks the j with A[i,j] != 0 (a ballot lists them), lane h
//      forms P in registers, sums da_i over j and the M1d / M1f partials
//      in registers, and reduces gd, grf and the local dA terms over h with
//      warp shuffles into shared memory (the k-chunk buffers, free after
//      rf);
//   B. when dv_j or ddeg is asked, warp w takes j = w, w + 8, ... and lane
//      h sums P over the tile's rows i (P recomputed from the staged
//      operands: a few FMA per (i, j, h)).
// gd, grf and the local dA terms go to f32 scratch [B,n,N,R] / [B,n,N]
// (only when dphi or dA asks); the sums over i (dv_j, ddeg, and over the
// block's rows the M1d, M1f and bias partials, reduced across the warps
// through shared memory in a fixed order) go to f32 per-block partials.
// The wrapper allocates all scratch with torch.empty.  h is walked in
// chunks of 64 inside the block (h > 64 recomputes rf per chunk, as the
// forward does), so the sums over h need no second pass.  The grid's
// third axis in the forward (h chunks) is left out for that reason.
// R > 4 walks the channels of the M1d / M1f partials in groups of kRg = 4
// (registers), recomputing the tile per group.
//
// Kernel 2 (motif_l3_grad_sums_kernel): one block per (tree b, tile of 32
// rows) sums the partials of dv_j and ddeg over kernel 1's row tiles, in
// order, and, when asked, computes the two contractions with grf as 32 x
// 32 output tiles through shared memory: dA's rows j (sum over (i, r) of
// grf x phi, plus the local terms) and dphi's rows i (gd plus grf times A's
// columns).  Further blocks, one per 32 columns of [M1d | M1f | bias], sum
// the per-block partials over all (b, row tile), each warp a fixed stride
// of them and then the warps in order.  Every sum runs in a fixed order,
// so a run reproduces bit for bit, with no atomics.  A third launch for
// the sums over B would only add a launch: the parameter blocks run beside
// the tree blocks in the same grid.
//
// Limits.  f32 CUDA cores, no tensor cores: every product is only R deep,
// as in the forward.  f32 and bf16 inputs, f32 accumulation and scratch,
// the gradients in the inputs' dtype.  Ragged N and h are masked, offsets
// are 64-bit, and shared memory is the forward's own layout (the backward's
// per-(i, j) sums alias its k-chunk buffers), so R is capped where the
// forward's is; beyond, the launch returns cudaErrorInvalidValue.
#include "motif_level3.cuh"

namespace {

constexpr int kRg = 4;     // M1d / M1f channels whose partials one pass keeps in registers
constexpr int kTo = 32;    // kernel 2's output tiles, kTo x kTo
constexpr unsigned kAll = 0xffffffffu;

// the gradients asked for, as bits of ``flags`` (the order of the inputs)
enum : int { kAdj = 1, kPhi = 2, kA = 4, kV = 8, kDeg = 16, kM1d = 32, kM1f = 64, kBias = 128 };

struct Grads {
  const void *adj, *phi, *a_i, *v_j, *deg, *m1d, *m1f, *bias, *g;   // inputs, T
  void *d_adj, *d_phi, *d_a, *d_v, *d_deg, *d_m1d, *d_m1f, *d_bias;  // gradients, T
  float *gd, *grf, *loc;   // [B,rows,N,R], [B,rows,N,R], [B,rows,N]
  float *pv, *pdeg, *pp;   // [B,tiles,N,h], [B,tiles,N], [B*tiles, (2R+1)h]
  int batch, n, row0, rows, r, h, tiles, flags;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

template <typename T, int kTk>
__global__ void __launch_bounds__(kThreads) motif_l3_grad_rows_kernel(Grads p, bool vec) {
  constexpr int kAp = kTk + 4, kAs = kTj * kAp;
  const int n = p.n, rows = p.rows, r = p.r, h = p.h, fl = p.flags;
  extern __shared__ float smem[];
  float* as = smem;                     // [2][kTj][kTk+4]  A[b, j-tile, k-chunk]
  float* ps = as + 2 * kAs;             // [2][kTi][kTk][r] phi[b, i-tile, k-chunk, :]
  float* rfs = ps + 2 * kTi * kTk * r;  // [kTi][kTj][r]    rf[b, i-tile, j-tile, :]
  float* pj = rfs + kTi * kTj * r;      // [kTi][kTj][r]    phi[b, i-tile, j-tile, :]
  float* mk = pj + kTi * kTj * r;       // [kTi][kTj]       A[b, row0 + i-tile, j-tile]
  float* dg = mk + kTi * kTj;           // [kTj]            deg[b, j-tile]
  float* vs = dg + kTj;                 // [kTj][kHc]       v_j[b, j-tile, h-chunk]
  float* wd = vs + kTj * kHc;           // [r][kHc]         M1d[:, h-chunk]
  float* wf = wd + r * kHc;             // [r][kHc]         M1f[:, h-chunk]
  // after rf_tile, until the next j-tile: the k-chunk buffers
  float* bs = as;                       // [kTi][kHc]       a_i + bias
  float* gs = bs + kTi * kHc;           // [kTi][kHc]       g
  float* sloc = gs + kTi * kHc;         // [kTi][kTj]       the local dA terms
  float* sgd = ps;                      // [kTi][kTj][r]    gd
  float* sgrf = sgd + kTi * kTj * r;    // [kTi][kTj][r]    grf
  float* red = vs;                      // [kHl][kThreads]  after the last j-tile

  const T* adj = static_cast<const T*>(p.adj);
  const T* phi = static_cast<const T*>(p.phi);
  const T* a_i = static_cast<const T*>(p.a_i);
  const T* v_j = static_cast<const T*>(p.v_j);
  const T* deg = static_cast<const T*>(p.deg);
  const T* m1d = static_cast<const T*>(p.m1d);
  const T* m1f = static_cast<const T*>(p.m1f);
  const T* bias = static_cast<const T*>(p.bias);
  const T* g = static_cast<const T*>(p.g);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int t = static_cast<int>(blockIdx.x % p.tiles);
  const int64_t b = blockIdx.x / p.tiles;
  const int64_t prow = b * p.tiles + t;             // this block's row of the partials
  const int64_t cols = static_cast<int64_t>(2 * r + 1) * h;
  const int i0 = t * kTi, i = i0 + w;               // this warp's row of the window
  const T* ab = adj + b * n * n;
  const T* pb = phi + b * rows * n * r;
  const T* mb = ab + static_cast<int64_t>(p.row0) * n;
  const bool want_loc = fl & kAdj, want_gd = fl & kPhi, want_grf = fl & (kAdj | kPhi);
  const bool pass_b = fl & (kV | kDeg);
  const int groups = (fl & (kM1d | kM1f)) && r > kRg ? (r + kRg - 1) / kRg : 1;

  // the block's sum over its rows (warps) of vals, in warp order, into the
  // partials' columns [col0 + hc0, col0 + hc0 + kHc)
  auto sum_rows = [&](const float (&vals)[kHl], int64_t col0, int hc0) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kHl; ++q) red[q * kThreads + tid] = vals[q];
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int q = 0; q < kHl; ++q) {
        const int hh = hc0 + lane + 32 * q;
        if (hh >= h) continue;
        float s = 0.f;
        for (int ww = 0; ww < kTi; ++ww) s += red[q * kThreads + ww * 32 + lane];
        p.pp[prow * cols + col0 + hh] = s;
      }
    }
  };

  for (int hc0 = 0; hc0 < h; hc0 += kHc) {
    for (int grp = 0; grp < groups; ++grp) {
      const bool first = grp == 0;      // the pass that does everything but M1's later channels
      const int rg0 = grp * kRg;
      __syncthreads();                  // the last pass's sums are out of red
      stage_m1(wd, wf, m1d, m1f, r, h, hc0);   // joins the first tile's copy group
      float base[kHl], gg[kHl], da[kHl], accd[kRg][kHl], accf[kRg][kHl];
#pragma unroll
      for (int q = 0; q < kHl; ++q) {
        const int hh = hc0 + lane + 32 * q;
        const bool ok = i < rows && hh < h;
        const int64_t o = (b * rows + i) * h + hh;
        base[q] = ok ? to_f(a_i[o]) + to_f(bias[hh]) : 0.f;
        gg[q] = ok ? to_f(g[o]) : 0.f;
        da[q] = 0.f;
#pragma unroll
        for (int k = 0; k < kRg; ++k) accd[k][q] = accf[k][q] = 0.f;
      }

      for (int j0 = 0; j0 < n; j0 += kTj) {
        __syncthreads();                // the last j-tile is done with the tiles
        stage_tile(pj, mk, dg, vs, pb, mb, deg, v_j, b, n, rows, r, h, i0, j0, hc0);
        rf_tile<kTk>(as, ps, rfs, ab, pb, n, rows, r, i0, j0, vec);
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          bs[w * kHc + lane + 32 * q] = base[q];
          gs[w * kHc + lane + 32 * q] = gg[q];
        }
        if (first) {
          sloc[w * kTj + lane] = 0.f;
          for (int rr = 0; rr < r; ++rr) sgd[(w * kTj + lane) * r + rr] =
                                             sgrf[(w * kTj + lane) * r + rr] = 0.f;
        }
        __syncwarp();

        // A. row i over its j with A[i,j] != 0
        if (i < rows) {
          unsigned live = __ballot_sync(kAll, mk[w * kTj + lane] != 0.f);
          while (live) {                // warp-uniform
            const int jj = __ffs(live) - 1;
            live &= live - 1;
            const float a = mk[w * kTj + jj], d = dg[jj];
            const float* pr = pj + (w * kTj + jj) * r;
            const float* fr = rfs + (w * kTj + jj) * r;
            float pq[kHl], loc_l = 0.f;
#pragma unroll
            for (int q = 0; q < kHl; ++q) {
              pq[q] = 0.f;
              if (hc0 + 32 * q >= h) continue;   // warp-uniform: no column of this half is live
              const int hl = lane + 32 * q;
              float e = base[q], f = vs[jj * kHc + hl];
              for (int rr = 0; rr < r; ++rr) {
                e = fmaf(pr[rr], wd[rr * kHc + hl], e);
                f = fmaf(fr[rr], wf[rr * kHc + hl], f);
              }
              const float c = fmaf(d, e, f), m = a * c, s = m > 0.f ? 1.f : kLeak;
              pq[q] = gg[q] * a * a * s;
              if (first) {
                da[q] = fmaf(d, pq[q], da[q]);
                loc_l += gg[q] * s * (m + a * c);   // g lrelu(m3) + A lrelu'(m3) g c
              }
#pragma unroll
              for (int k = 0; k < kRg; ++k) {
                if (rg0 + k >= r) break;
                accd[k][q] = fmaf(pr[rg0 + k] * d, pq[q], accd[k][q]);
                accf[k][q] = fmaf(fr[rg0 + k], pq[q], accf[k][q]);
              }
            }
            if (first && want_loc) {
              const float v = warp_sum(loc_l);
              if (lane == 0) sloc[w * kTj + jj] = v;
            }
            if (first && want_grf) {
              for (int rr = 0; rr < r; ++rr) {
                float sf = 0.f, sd = 0.f;
#pragma unroll
                for (int q = 0; q < kHl; ++q) {
                  sf = fmaf(pq[q], wf[rr * kHc + lane + 32 * q], sf);
                  sd = fmaf(pq[q], wd[rr * kHc + lane + 32 * q], sd);
                }
                sf = warp_sum(sf);
                if (want_gd) sd = warp_sum(sd);
                if (lane == 0) {
                  sgrf[(w * kTj + jj) * r + rr] = sf;
                  sgd[(w * kTj + jj) * r + rr] = d * sd;
                }
              }
            }
          }
        }
        if (!first) continue;
        __syncthreads();                // A's sums and every warp's bs, gs

        // this tile's per-(i, j) sums out, thread (w, lane) -> (i, j0 + lane),
        // added over the h chunks
        const int jl = j0 + lane;
        if (i < rows && jl < n) {
          const int64_t o = (b * rows + i) * n + jl;
          if (want_loc) p.loc[o] = (hc0 == 0 ? 0.f : p.loc[o]) + sloc[w * kTj + lane];
          for (int rr = 0; rr < r && want_grf; ++rr) {
            const int64_t orr = o * r + rr;
            const float* s = sgrf + (w * kTj + lane) * r;
            p.grf[orr] = (hc0 == 0 ? 0.f : p.grf[orr]) + s[rr];
            if (want_gd) p.gd[orr] = (hc0 == 0 ? 0.f : p.gd[orr]) + sgd[(w * kTj + lane) * r + rr];
          }
        }

        // B. column j over the tile's rows i with A[i,j] != 0
        if (pass_b) {
          for (int jj = w; jj < kTj && j0 + jj < n; jj += kTi) {   // warp-uniform
            const float d = dg[jj];
            float dv[kHl] = {}, sdeg = 0.f;
            for (int ii = 0; ii < kTi && i0 + ii < rows; ++ii) {
              const float a = mk[ii * kTj + jj];
              if (a == 0.f) continue;
              const float* pr = pj + (ii * kTj + jj) * r;
              const float* fr = rfs + (ii * kTj + jj) * r;
#pragma unroll
              for (int q = 0; q < kHl; ++q) {
                if (hc0 + 32 * q >= h) continue;
                const int hl = lane + 32 * q;
                float e = bs[ii * kHc + hl], f = vs[jj * kHc + hl];
                for (int rr = 0; rr < r; ++rr) {
                  e = fmaf(pr[rr], wd[rr * kHc + hl], e);
                  f = fmaf(fr[rr], wf[rr * kHc + hl], f);
                }
                const float c = fmaf(d, e, f), m = a * c, s = m > 0.f ? 1.f : kLeak;
                const float pij = gs[ii * kHc + hl] * a * a * s;
                dv[q] += pij;
                sdeg = fmaf(pij, e, sdeg);
              }
            }
            const int64_t o = prow * n + j0 + jj;
            if (fl & kV) {
#pragma unroll
              for (int q = 0; q < kHl; ++q) {
                const int hh = hc0 + lane + 32 * q;
                if (hh < h) p.pv[o * h + hh] = dv[q];
              }
            }
            if (fl & kDeg) {
              sdeg = warp_sum(sdeg);
              if (lane == 0) p.pdeg[o] = (hc0 == 0 ? 0.f : p.pdeg[o]) + sdeg;
            }
          }
        }
      }

      // the block's partials of this h chunk, summed over its rows
      if (first && (fl & kA) && i < rows) {
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          const int hh = hc0 + lane + 32 * q;
          if (hh < h) static_cast<T*>(p.d_a)[(b * rows + i) * h + hh] = from_f<T>(da[q]);
        }
      }
      if (first && (fl & kBias)) sum_rows(da, 2 * static_cast<int64_t>(r) * h, hc0);
#pragma unroll
      for (int k = 0; k < kRg; ++k) {
        const int rr = rg0 + k;
        if (rr >= r) break;
        if (fl & kM1d) sum_rows(accd[k], static_cast<int64_t>(rr) * h, hc0);
        if (fl & kM1f) sum_rows(accf[k], static_cast<int64_t>(r + rr) * h, hc0);
      }
    }
  }
}

// acc[m] = sum_l x(w + 8m, l) y(l, lane) for l < len, the output tile's
// rows w, w + 8, w + 16, w + 24 and column lane; x and y read 0 outside.
template <typename FX, typename FY>
__device__ __forceinline__ void tile_product(float (*xs)[kTo + 1], float (*ys)[kTo + 1], int len,
                                             FX x, FY y, float (&acc)[4]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] = 0.f;
  for (int l0 = 0; l0 < len; l0 += kTo) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTo * kTo; e += kThreads) {
      const int row = e / kTo, col = e % kTo;
      xs[row][col] = x(row, l0 + col);
      ys[row][col] = y(l0 + row, col);
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTo; ++c) {
      const float yv = ys[c][lane];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = fmaf(xs[w + 8 * m][c], yv, acc[m]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) motif_l3_grad_sums_kernel(Grads p, int tree_blocks) {
  __shared__ float xs[kTo][kTo + 1], ys[kTo][kTo + 1], red[kTi][32];
  const int n = p.n, rows = p.rows, r = p.r, h = p.h, fl = p.flags, tiles = p.tiles;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;

  if (static_cast<int>(blockIdx.x) >= tree_blocks) {
    // [M1d | M1f | bias], 32 columns: warp w sums the partial rows w, w + 8,
    // ... (four chains), then warp 0 the warps in order
    const int64_t cols = static_cast<int64_t>(2 * r + 1) * h;
    const int64_t col = static_cast<int64_t>(blockIdx.x - tree_blocks) * 32 + lane;
    const int64_t nrows = static_cast<int64_t>(p.batch) * tiles;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    if (col < cols) {
      int64_t q = w;
      for (; q + 3 * kTi < nrows; q += 4 * kTi) {
        s0 += p.pp[q * cols + col];
        s1 += p.pp[(q + kTi) * cols + col];
        s2 += p.pp[(q + 2 * kTi) * cols + col];
        s3 += p.pp[(q + 3 * kTi) * cols + col];
      }
      for (; q < nrows; q += kTi) s0 += p.pp[q * cols + col];
    }
    red[w][lane] = (s0 + s1) + (s2 + s3);
    __syncthreads();
    if (w != 0 || col >= cols) return;
    float s = 0.f;
    for (int ww = 0; ww < kTi; ++ww) s += red[ww][lane];
    const int64_t rh = static_cast<int64_t>(r) * h;
    if (col < rh) {
      if (fl & kM1d) static_cast<T*>(p.d_m1d)[col] = from_f<T>(s);
    } else if (col < 2 * rh) {
      if (fl & kM1f) static_cast<T*>(p.d_m1f)[col - rh] = from_f<T>(s);
    } else if (fl & kBias) {
      static_cast<T*>(p.d_bias)[col - 2 * rh] = from_f<T>(s);
    }
    return;
  }

  const int row_tiles = (n + kTo - 1) / kTo;
  const int m0 = static_cast<int>(blockIdx.x % row_tiles) * kTo;
  const int64_t b = blockIdx.x / row_tiles;
  const T* adj = static_cast<const T*>(p.adj);
  const T* phi = static_cast<const T*>(p.phi);

  // dv_j and ddeg of rows j in [m0, m0 + kTo): kernel 1's partials, in row-tile order
  if (fl & kV) {
    for (int e = tid; e < kTo * h; e += kThreads) {
      const int j = m0 + e / h, hh = e % h;
      if (j >= n) break;
      float s = 0.f;
      for (int tt = 0; tt < tiles; ++tt) s += p.pv[((b * tiles + tt) * n + j) * h + hh];
      static_cast<T*>(p.d_v)[(b * n + j) * h + hh] = from_f<T>(s);
    }
  }
  if (fl & kDeg) {
    for (int e = tid; e < kTo && m0 + e < n; e += kThreads) {
      float s = 0.f;
      for (int tt = 0; tt < tiles; ++tt) s += p.pdeg[(b * tiles + tt) * n + m0 + e];
      static_cast<T*>(p.d_deg)[b * n + m0 + e] = from_f<T>(s);
    }
  }

  float acc[4];
  // dA rows j in [m0, m0 + kTo): sum over l = (i, r) of grf[i, j, r] phi[i, k, r],
  // plus the local terms where j is a row of the window
  if (fl & kAdj) {
    const int len = rows * r;
    for (int k0 = 0; k0 < n; k0 += kTo) {
      tile_product(
          xs, ys, len,
          [&](int jj, int l) {
            return m0 + jj < n && l < len
                       ? p.grf[((b * rows + l / r) * n + m0 + jj) * r + l % r] : 0.f;
          },
          [&](int l, int kk) {
            return l < len && k0 + kk < n
                       ? to_f(phi[((b * rows + l / r) * n + k0 + kk) * r + l % r]) : 0.f;
          },
          acc);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = m0 + w + 8 * m, k = k0 + lane;
        if (j >= n || k >= n) continue;
        float v = acc[m];
        if (j >= p.row0 && j < p.row0 + rows) v += p.loc[(b * rows + j - p.row0) * n + k];
        static_cast<T*>(p.d_adj)[(b * n + j) * n + k] = from_f<T>(v);
      }
    }
  }
  // dphi rows i in [m0, m0 + kTo) of the window: gd + sum_j grf[i, j, r] A[j, k]
  if ((fl & kPhi) && m0 < rows) {
    for (int rr = 0; rr < r; ++rr) {
      for (int k0 = 0; k0 < n; k0 += kTo) {
        tile_product(
            xs, ys, n,
            [&](int ii, int j) {
              return m0 + ii < rows && j < n ? p.grf[((b * rows + m0 + ii) * n + j) * r + rr]
                                             : 0.f;
            },
            [&](int j, int kk) {
              return j < n && k0 + kk < n ? to_f(adj[(b * n + j) * n + k0 + kk]) : 0.f;
            },
            acc);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = m0 + w + 8 * m, k = k0 + lane;
          if (i >= rows || k >= n) continue;
          const int64_t o = ((b * rows + i) * n + k) * r + rr;
          static_cast<T*>(p.d_phi)[o] = from_f<T>(p.gd[o] + acc[m]);
        }
      }
    }
  }
}

template <typename T, int kTk>
int launch(const Grads& p, void* stream) {
  const size_t smem = sizeof(float) * smem_floats<kTk>(p.r);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(p.batch) * p.tiles;
  const int row_tiles = (p.n + kTo - 1) / kTo;
  const int64_t tree_blocks = static_cast<int64_t>(p.batch) * row_tiles;
  const int64_t cols = static_cast<int64_t>(2 * p.r + 1) * p.h;
  const int64_t param_blocks = (p.flags & (kM1d | kM1f | kBias)) ? (cols + 31) / 32 : 0;
  if (blocks > 0x7fffffffLL || tree_blocks + param_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = std::is_same<T, float>::value && p.n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.adj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.phi) % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        motif_l3_grad_rows_kernel<T, kTk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  motif_l3_grad_rows_kernel<T, kTk><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  motif_l3_grad_sums_kernel<T><<<static_cast<unsigned>(tree_blocks + param_blocks), kThreads, 0,
                                 s>>>(p, static_cast<int>(tree_blocks));
  return static_cast<int>(cudaGetLastError());
}

// k-chunks 32 wide where one covers the tree, 128 wide beyond (the forward's)
template <typename T>
int launch(const Grads& p, void* stream) {
  return p.n <= 32 ? launch<T, 32>(p, stream) : launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Inputs as motif_level3_launch takes
// them, g [B,rows,H] the gradient of nt; the gradients in the inputs'
// shapes and dtype (d_a the window's rows), null where ``flags`` does not
// ask (bit k: the k-th of adj, phi, a_i, v_j, deg, m1d, m1f, bias).  f32
// scratch, each needed only for the flags named: gd [B,rows,N,R] (phi), grf
// [B,rows,N,R] (adj or phi), loc [B,rows,N] (adj), pv [B,tiles,N,H] (v_j),
// pdeg [B,tiles,N] (deg), pp [B*tiles, (2R+1)H] (m1d, m1f or bias), with
// tiles = ceil(rows / 8).  All contiguous.  Two launches on ``stream``.
extern "C" int motif_level3_backward_launch(
    const void* adj, const void* phi, const void* a_i, const void* v_j, const void* deg,
    const void* m1d, const void* m1f, const void* bias, const void* g, void* d_adj,
    void* d_phi, void* d_a, void* d_v, void* d_deg, void* d_m1d, void* d_m1f, void* d_bias,
    float* gd, float* grf, float* loc, float* pv, float* pdeg, float* pp, int batch, int n,
    int row0, int rows, int r, int h, int tiles, int flags, int dtype, void* stream) {
  if (row0 < 0 || rows < 0 || row0 + rows > n || r < 0 || h < 0 ||
      tiles != (rows + kTi - 1) / kTi || (flags & ~255) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool missing =
      ((flags & kAdj) && (!d_adj || !grf || !loc)) || ((flags & kPhi) && (!d_phi || !gd || !grf)) ||
      ((flags & kA) && !d_a) || ((flags & kV) && (!d_v || !pv)) ||
      ((flags & kDeg) && (!d_deg || !pdeg)) || ((flags & kM1d) && (!d_m1d || !pp)) ||
      ((flags & kM1f) && (!d_m1f || !pp)) || ((flags & kBias) && (!d_bias || !pp));
  if (missing) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || rows == 0 || h == 0 || flags == 0) return 0;
  const Grads p{adj, phi, a_i, v_j, deg, m1d, m1f, bias, g,
                d_adj, d_phi, d_a, d_v, d_deg, d_m1d, d_m1f, d_bias,
                gd, grf, loc, pv, pdeg, pp, batch, n, row0, rows, r, h, tiles, flags};
  if (dtype == 0) return launch<float>(p, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
