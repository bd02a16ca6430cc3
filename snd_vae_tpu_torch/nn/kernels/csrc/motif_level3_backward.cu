// motif_level3_backward: the gradient of motif_level3 (csrc/motif_level3.cu)
// for g = dL/dnt, in one launch on the model's path.  With c[i,j,:] the
// bracket of m3 (so m3 = A[i,j] c), e = a_i + bias + sum_r phi M1d its deg
// side, and lrelu'(x) = 1 for x > 0, 0.2 otherwise:
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
// m3, d_ij and wf.  No kernel here writes a [B,n,N,h] tensor.
//
// What bounds it on an H100.  Bytes: A, phi, a_i, v_j, deg and g read, the
// asked-for gradients written: ~2.3 MB per layer at the served shape
// (B = 100 trees, N = 25, h = 50, R = 1, f32), ~0.7 us at 3.35 TB/s.
// Operations: rf's recompute (2R FLOP per (i,j,k) with A[i,j] != 0 and
// A[j,k] != 0) and ~8R + 11 FLOP per (i,j,h) with A[i,j] != 0 on the
// model's path; the served spanning trees are ~8% dense, so a few MFLOP, a
// fraction of a microsecond on the f32 CUDA cores.  chip_smoke.py's
// level3_backward_bound counts both from the batch's trees.  So it is bound
// by neither: its time is a chain of dependent waits (memory round trips,
// barriers, launches), and the design shortens that chain.  Every product
// is only R deep and a tile is a few KB, so neither wgmma nor TMA has
// anything to do here; the work stays on the f32 CUDA cores.
//
// The main kernel (motif_l3_grad_kernel): one block per row tile of kTi =
// 8 rows of the window (tiles = ceil(rows / 8)), 8 warps, one row each.
// A tree of at most 4 row tiles (N <= 32, the model's path) is one
// thread-block cluster of C = tiles blocks; a larger one is split into
// clusters = ceil(tiles / 2) clusters of C = 2, block q of the tree taking
// row tile q (the last block of a tree may have none: it adds zeros).
// Clusters stay far below the portable 8 because the generic instance
// takes one block an SM: at [4,256,256,50] its 32 clusters of 4 did not
// all fit the card's GPCs at once and ran in two waves (clusters of 8
// likewise); clusters of 2 fit, and a tree of 4 row tiles (N = 29) ran
// faster as one cluster than as two.  For each h chunk (32 columns, one
// per lane, in the model's instance where h <= 32; else 64, two per lane)
// and each j-tile of 32 it recomputes rf exactly as the forward does (the
// shared rf_tile: k-chunks of A and phi through shared memory,
// double-buffered with cp.async, the tile's other operands in the first
// chunk's copy group), then
//   A. warp i walks the j with A[i,j] != 0 (a ballot lists them), two at a
//      time so that their loads overlap; lane h forms P in registers, sums
//      da_i over j and the M1d / M1f partials in registers, and reduces gd,
//      grf and the local dA terms over h with warp shuffles into shared
//      memory (only when dphi or dA asks);
//   B. when dv_j or ddeg is asked, warp w takes j = w, w + 8, ... and walks
//      the rows i with A[i,j] != 0 (A's ballots, as bits); lane h sums P
//      over them in registers (P recomputed from the staged operands: a few
//      FMA per (i, j, h)).
// The sums over a cluster's rows stay on chip: each block pushes its dv_j /
// ddeg partial of the j-tile and, after the last j-tile, its M1d / M1f /
// bias partial (summed over its warps in a fixed order, one barrier pair
// for all 2R + 1 rows) into the shared memory of the rank that sums those
// columns (distributed shared memory stores, one slot per sending rank);
// after one cluster barrier each rank sums its slots in rank order, from
// its own shared memory, and writes dv_j (and ddeg) and its share of the
// cluster's parameter partial.  A block arrives on the cluster barrier when
// it starts and waits for that phase before its first push, so it writes
// only into blocks that have started; the rf recompute in between hides
// the wait.  The receive buffers alternate between two halves, so one
// cluster barrier per exchange suffices, and since no block reads another's
// shared memory after the last barrier, none waits for the others before
// it leaves.  Where a tree takes one cluster (N <= 64, the model's path)
// those sums are the tree's.  Where it takes several, each cluster writes
// its dv_j / ddeg sums to L2; for each rank, the last of the tree's blocks
// of that rank, elected by one atomic increment per block of a per-(tree,
// rank) counter, sums that rank's columns over the tree's clusters in
// order.
//
// The sums over trees finish in the same launch: every block, once its
// share of the cluster partials is written and fenced, takes one atomic
// increment of a counter in device memory; the block that takes the last
// one sums the per-cluster partials in a fixed order (16-byte loads from
// L2, the rows split over the threads in fixed stripes, the stripes summed
// in order), writes dM1d, dM1f and dbias, and resets the counter to 0 for
// the next launch (so the launch can be captured in a CUDA graph), as the
// trees' last blocks reset theirs.  Only the elections are atomic; every
// float sum has a fixed order, so a run reproduces bit for bit.  The
// counters belong to one stream: launches on one stream run one after
// another.
//
// Why the model's path has an instance of its own: where the loops over h
// chunks and j-tiles run at run time, the compiler keeps their invariant
// staging addresses in registers for the loops' whole length, more than
// the 128 at which two blocks fit an SM, so 400 blocks (100 trees of 25
// nodes) take two waves.  In the model's instance (N <= 32: one j-tile;
// h <= 64: one h chunk; R = 1) they are constants: no such loop is left,
// and it fits 64 registers, four blocks an SM, one wave.  Every other
// shape takes the one generic instance (k-chunks of 128, runtime loops,
// the M1 partials of up to four channels in registers).
//
// The contraction kernel (motif_l3_grad_contract_kernel), a second launch
// made only when dA or dphi is asked (off the model's path): the main
// kernel writes gd, grf and the local dA terms to f32 scratch [B,n,N,R] /
// [B,n,N], and one block per (tree b, tile of 32 rows) forms dA's rows j
// (sum over (i, r) of grf x phi, plus the local terms) and dphi's rows i
// (gd plus grf times A's columns) as 32 x 32 output tiles through shared
// memory.
//
// Limits.  f32 CUDA cores, no tensor cores.  f32 and bf16 inputs, f32
// accumulation and scratch, the gradients in the inputs' dtype.  Ragged N
// and h are masked, offsets are 64-bit, h > 64 recomputes rf per h chunk,
// and R > 4 walks the channels of the M1d / M1f partials in groups of 4
// (registers), recomputing the tile per group.  Shared memory is the
// forward's layout (whose buffers the backward's per-(i, j) sums and the
// block's row reduction alias) plus 2 KB for da_i and the receive buffers
// (~19 KB at h > 32, R = 1), so R is capped a little below the forward's
// cap; beyond, the launch returns cudaErrorInvalidValue.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "motif_level3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRgMax = 4;       // M1d / M1f channels whose partials one pass keeps in registers
constexpr int kTo = 32;         // the contraction kernel's output tiles, kTo x kTo
constexpr int kMaxCluster = 4;    // a tree of at most this many row tiles is one cluster,
constexpr int kSplitCluster = 2;  // a larger one clusters of this many blocks (see the header)
constexpr int kBatch = 8;       // loads in flight per thread in the sums over clusters
constexpr unsigned kAll = 0xffffffffu;

// the gradients asked for, as bits of ``flags`` (the order of the inputs)
enum : int { kAdj = 1, kPhi = 2, kA = 4, kV = 8, kDeg = 16, kM1d = 32, kM1f = 64, kBias = 128 };

struct Dims {
  int batch, n, row0, rows, r, h, tiles, clusters, cols4, flags;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// the address in block ``rank``'s shared memory that ``p`` has in this one
__device__ __forceinline__ uint32_t remote(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_rank(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote(p, rank)), "f"(v) : "memory");
}
// An array of E floats (E a multiple of 4) summed over a cluster of cl
// blocks: rank o sums the quads [o uq, (o + 1) uq), uq = ceil(E / 4 / cl),
// and receives them as [cl][uq] quads, one row per sending rank.  Element e
// of rank ``from`` goes to rank ``rank`` at float ``offset``.  The quotient
// by uq goes through a float reciprocal (exact here: u < 2^12), which costs
// two instructions where an integer division costs some twenty.
struct Dest {
  int rank, offset;
};
struct Spread {
  int uq;
  float inv;
  __device__ __forceinline__ Spread(int E, int cl) : uq((E / 4 + cl - 1) / cl), inv(1.f / uq) {}
  __device__ __forceinline__ Dest operator()(int e, int from) const {
    const int u = e / 4, o = static_cast<int>((u + 0.5f) * inv);
    return {o, (from * uq + u - o * uq) * 4 + e % 4};
  }
};
__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
// This rank's quads of an array that Spread placed (the receive buffer
// ``buf``), each summed over the sending ranks in rank order: f(u, sum) for
// quad u of the array.
template <typename F>
__device__ __forceinline__ void own4(const float* buf, int E, int cl, int rank, F f) {
  const int uq = (E / 4 + cl - 1) / cl;
  for (int lu = threadIdx.x; lu < uq && rank * uq + lu < E / 4; lu += kThreads) {
    float4 s = *reinterpret_cast<const float4*>(buf + 4 * lu);
    for (int q = 1; q < cl; ++q) add4(s, *reinterpret_cast<const float4*>(buf + 4 * (q * uq + lu)));
    f(rank * uq + lu, s);
  }
}

// Shared memory of one block of the main kernel, in floats: the forward's
// layout (which the block's row reduction aliases), the receive buffers of
// the cluster's sums, two halves each (Spread's [cl][uq] quads: at most 4 cl
// floats past the array): dv_j [kTj][kHc], the parameter partials
// [2 min(R, 4) + 1][kHc] and ddeg [kTj]; then the sums of da_i [kTi][kHc].
__host__ __device__ constexpr int recv_floats(int e) {
  return e + 4 * kMaxCluster;
}
template <int kTk, int kHc>
constexpr size_t main_smem_floats(int r) {
  const int g = r < kRgMax ? r : kRgMax;
  return smem_floats<kTk, kHc>(r) + kTi * kHc +
         2 * (recv_floats(kTj * kHc) + recv_floats((2 * g + 1) * kHc) +
              recv_floats(kTj));
}

// Four blocks of 256 threads an SM in the model's instance (kTk = 32; 64
// registers a thread), so that its B·ceil(N/8) blocks (400 at 100 trees of
// 25 nodes) run in one wave; one in the generic instance, which keeps its
// registers so (capped at 128, two blocks an SM, it spilled ~290 bytes in
// its inner loops and ran slower than the earlier two-kernel backward at
// N = 72 and R = 5).
template <typename T, int kTk, int kHl, bool kOneH, int kRg>
__global__ void __launch_bounds__(kThreads, kTk == 32 ? 4 : 1)
    motif_l3_grad_kernel(
    const T* __restrict__ adj, const T* __restrict__ phi, const T* __restrict__ a_i,
    const T* __restrict__ v_j, const T* __restrict__ deg, const T* __restrict__ m1d,
    const T* __restrict__ m1f, const T* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ d_a, T* __restrict__ d_v, T* __restrict__ d_deg, T* __restrict__ d_m1d,
    T* __restrict__ d_m1f, T* __restrict__ d_bias, float* __restrict__ gd,
    float* __restrict__ grf, float* __restrict__ loc, float* __restrict__ pdeg,
    float* __restrict__ pv, float* __restrict__ pp, unsigned* __restrict__ counter, const Dims d,
    const bool vec) {
  constexpr int kHc = 32 * kHl;
  // In the kRg = 1 instances (R = 1, the model's path) r is a constant, so
  // every shared-memory offset below is one and no register holds it
  const int n = d.n, rows = d.rows, r = kRg == 1 ? 1 : d.r, h = d.h, fl = d.flags;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                     // [2][kTj][kTk+4]  A[b, j-tile, k-chunk]
  float* ps = as + 2 * kTj * (kTk + 4); // [2][kTi][kTk][r] phi[b, i-tile, k-chunk, :]
  float* rfs = ps + 2 * kTi * kTk * r;  // [kTi][kTj][r]    rf[b, i-tile, j-tile, :]
  float* pj = rfs + kTi * kTj * r;      // [kTi][kTj][r]    phi[b, i-tile, j-tile, :]
  float* mk = pj + kTi * kTj * r;       // [kTi][kTj]       A[b, row0 + i-tile, j-tile]
  float* dg = mk + kTi * kTj;           // [kTj]            deg[b, j-tile]
  float* vs = dg + kTj;                 // [kTj][kHc]       v_j[b, j-tile, h-chunk]
  float* wd = vs + kTj * kHc;           // [r][kHc]         M1d[:, h-chunk]
  float* wf = wd + r * kHc;             // [r][kHc]         M1f[:, h-chunk]
  // after rf_tile, until the next tile: the k-chunk buffers
  float* bs = as;                       // [kTi][kHc]       a_i + bias
  float* gs = bs + kTi * kHc;           // [kTi][kHc]       g
  float* sloc = gs + kTi * kHc;         // [kTi][kTj]       the local dA terms
  float* sgd = ps;                      // [kTi][kTj][r]    gd
  float* sgrf = sgd + kTi * kTj * r;    // [kTi][kTj][r]    grf
  // at the end of a pass: the warps' parameter partials [2g+1][kTi][kHc]
  float* red = smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int gmax = r < kRgMax ? r : kRgMax;
  // the receive buffers, two halves each: the j-tile's dv_j, the parameter
  // partials, the j-tile's ddeg
  const int nv = recv_floats(kTj * kHc), np = recv_floats((2 * gmax + 1) * kHc),
            nd = recv_floats(kTj);
  float* rv = wf + r * kHc;
  float* rp = rv + 2 * nv;
  float* rd = rp + 2 * np;
  float* das = rd + 2 * nd;             // [kTi][kHc]       da_i of the block's rows
  __shared__ unsigned live_j[kTi];      // row i's j with A[i,j] != 0 in the j-tile, as bits
  __shared__ int last_block, last_in_tree;

  // started: this block may write into its siblings' shared memory (it has
  // waited for the phase that every block of the cluster arrives on here)
  hk::cluster_arrive_relaxed();
  bool started = false;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  // N <= 32 (k-chunks of 32): one j-tile, at most 4 row tiles, one cluster a tree
  constexpr bool kOneTile = kTk == 32;
  static_assert(kMaxCluster * kTi >= kTj, "the model's instance takes one cluster a tree");
  const int clusters = kOneTile ? 1 : d.clusters, per_tree = clusters * cl;
  const int64_t b = blockIdx.x / per_tree;
  // this block's cluster in the tree, and the row of the cluster partials
  const int part = kOneTile ? 0 : static_cast<int>(blockIdx.x % per_tree) / cl;
  const int64_t bp = b * clusters + part;
  // the block's row tile (none, past the window, in a cluster's padding block)
  const int i0 = (part * cl + rank) * kTi, i = i0 + w;
  const T* ab = adj + b * n * n;
  const T* pb = phi + b * rows * n * r;
  const T* mb = ab + static_cast<int64_t>(d.row0) * n;
  const bool want_loc = fl & kAdj, want_gd = fl & kPhi, want_grf = fl & (kAdj | kPhi);
  const bool want_dv = fl & (kV | kDeg), want_pp = fl & (kM1d | kM1f | kBias);
  const int groups = (fl & (kM1d | kM1f)) && r > kRg ? (r + kRg - 1) / kRg : 1;
  const int n_hc = kOneH ? 1 : (h + kHc - 1) / kHc;
  const Spread to_v(kTj * kHc, cl), to_d(kTj, cl);
  int step = 0;                         // exchanges so far: the buffers' half is step & 1
  bool wrote = false;                   // this thread wrote cluster partials others sum
  // before this block's first push into its siblings' shared memory
  auto start = [&] {
    if (!started) hk::cluster_wait();
    started = true;
  };

  // after a cluster barrier: this rank's share of the j-tile's dv_j / ddeg
  // sums, out of its receive buffers; the tree's where it is one cluster,
  // else the cluster's, to L2
  auto finish_dv = [&](int j0, int hc0, int hc) {
    if (fl & kV)
      own4(rv + (step & 1) * nv, kTj * kHc, cl, rank, [&](int u, float4 s) {
        const int jj = 4 * u / kHc, hl = 4 * u % kHc, j = j0 + jj;
        if (j >= n) return;
        const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int hh = hc0 + hl + k;
          if (hh >= h) break;
          if (clusters == 1) {
            d_v[(b * n + j) * h + hh] = from_f<T>(v[k]);
          } else {
            pv[(bp * n + j) * h + hh] = v[k];
            wrote = true;
          }
        }
      });
    if (fl & kDeg)
      own4(rd + (step & 1) * nd, kTj, cl, rank, [&](int u, float4 s) {
        const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + 4 * u + k;
          if (j >= n) break;
          float* acc = pdeg + bp * n + j;  // the sum over the h chunks
          const float t = hc == 0 ? v[k] : *acc + v[k];
          *acc = t;
          if (hc == n_hc - 1) {
            if (clusters == 1) d_deg[b * n + j] = from_f<T>(t);
            else wrote = true;
          }
        }
      });
  };

  for (int hc = 0; hc < n_hc; ++hc) {
    const int hc0 = hc * kHc;
    for (int grp = 0; grp < groups; ++grp) {
      const bool first = grp == 0;      // the pass that does everything but M1's later channels
      const int rg0 = grp * kRg, gch = r - rg0 < kRg ? r - rg0 : kRg;
      float accd[kRg][kHl], accf[kRg][kHl];
#pragma unroll
      for (int k = 0; k < kRg; ++k)
#pragma unroll
        for (int q = 0; q < kHl; ++q) accd[k][q] = accf[k][q] = 0.f;

      for (int j0 = 0; j0 < (kOneTile ? 1 : n); j0 += kTj) {
        float dv[kTj / kTi][kHl] = {}, sdeg[kTj / kTi] = {};
        __syncthreads();              // the last tile is done with the buffers
        if (j0 == 0) stage_m1<kHc>(wd, wf, m1d, m1f, r, h, hc0);
        float base[kHl], gg[kHl];
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          const int hh = hc0 + lane + 32 * q;
          const bool ok = i < rows && hh < h;
          const int64_t o = (b * rows + i) * h + hh;
          base[q] = ok ? to_f(a_i[o]) + to_f(bias[hh]) : 0.f;
          gg[q] = ok ? to_f(g[o]) : 0.f;
        }
        stage_tile<kHc>(pj, mk, dg, vs, pb, mb, deg, v_j, b, n, rows, r, h, i0, j0, hc0);
        rf_tile<kTk>(as, ps, rfs, ab, pb, n, rows, r, i0, j0, vec);
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          bs[w * kHc + lane + 32 * q] = base[q];
          gs[w * kHc + lane + 32 * q] = gg[q];
        }
        if (first && want_grf) {
          sloc[w * kTj + lane] = 0.f;
          for (int rr = 0; rr < r; ++rr)
            sgd[(w * kTj + lane) * r + rr] = sgrf[(w * kTj + lane) * r + rr] = 0.f;
        }
        __syncwarp();

        // M1d / M1f of the lane's columns, channel 0 in registers
        float wd0[kHl], wf0[kHl];
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          wd0[q] = wd[lane + 32 * q];
          wf0[q] = wf[lane + 32 * q];
        }
        // c = deg_j (a_i + bias + phi_ij M1d) + v_j + rf_ij M1f, its deg side e
        auto bracket = [&](const float* pr, const float* fr, float e, float f, float dj,
                           int q, float& c) {
          const int hl = lane + 32 * q;
          if (r > 0) {
            e = fmaf(pr[0], wd0[q], e);
            f = fmaf(fr[0], wf0[q], f);
          }
          for (int rr = 1; rr < r; ++rr) {
            e = fmaf(pr[rr], wd[rr * kHc + hl], e);
            f = fmaf(fr[rr], wf[rr * kHc + hl], f);
          }
          c = fmaf(dj, e, f);
          return e;
        };

        // A. row i over its j with A[i,j] != 0 (mk is 0 past the window's
        // rows), two j at a time so that their loads overlap; the second
        // of a pair that has none reads the first's operands with A = 0 and
        // adds exact zeros
        float da[kHl] = {};
        unsigned live = __ballot_sync(kAll, mk[w * kTj + lane] != 0.f);
        if (lane == 0) live_j[w] = live;
        auto pass_a = [&](int jj, bool real) {
          const float a = real ? mk[w * kTj + jj] : 0.f, dj = dg[jj];
          const float* pr = pj + (w * kTj + jj) * r;
          const float* fr = rfs + (w * kTj + jj) * r;
          float pq[kHl], loc_l = 0.f;
#pragma unroll
          for (int q = 0; q < kHl; ++q) {
            pq[q] = 0.f;
            if (hc0 + 32 * q >= h) continue;   // warp-uniform: no column of this half is live
            float c;
            bracket(pr, fr, base[q], vs[jj * kHc + lane + 32 * q], dj, q, c);
            const float m = a * c, s = m > 0.f ? 1.f : kLeak;
            pq[q] = gg[q] * a * a * s;
            if (first) {
              da[q] = fmaf(dj, pq[q], da[q]);
              loc_l += gg[q] * s * (m + a * c);   // g lrelu(m3) + A lrelu'(m3) g c
            }
#pragma unroll
            for (int k = 0; k < kRg; ++k) {
              if (k >= gch) break;
              accd[k][q] = fmaf(pr[rg0 + k] * dj, pq[q], accd[k][q]);
              accf[k][q] = fmaf(fr[rg0 + k], pq[q], accf[k][q]);
            }
          }
          if (first && want_loc) {
            const float v = warp_sum(loc_l);
            if (real && lane == 0) sloc[w * kTj + jj] = v;
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
              if (real && lane == 0) {
                sgrf[(w * kTj + jj) * r + rr] = sf;
                sgd[(w * kTj + jj) * r + rr] = dj * sd;
              }
            }
          }
        };
        while (live) {                // warp-uniform
          const int j1 = __ffs(live) - 1;
          live &= live - 1;
          const bool two = live != 0;
          const int j2 = two ? __ffs(live) - 1 : j1;
          if (two) live &= live - 1;
          pass_a(j1, true);
          pass_a(j2, two);
        }
        if (!first) continue;         // block-uniform
        // da_i over the j-tiles (read by this thread only)
        float* dat = das + w * kHc;
#pragma unroll
        for (int q = 0; q < kHl; ++q)
          dat[lane + 32 * q] = (j0 == 0 ? 0.f : dat[lane + 32 * q]) + da[q];
        __syncthreads();              // A's sums and every warp's bs, gs

        // this tile's per-(i, j) sums out, thread (w, lane) -> (i, j0 + lane),
        // added over the h chunks
        const int jl = j0 + lane;
        if (want_grf && i < rows && jl < n) {
          const int64_t o = (b * rows + i) * n + jl;
          if (want_loc) loc[o] = (hc0 == 0 ? 0.f : loc[o]) + sloc[w * kTj + lane];
          for (int rr = 0; rr < r; ++rr) {
            const int64_t orr = o * r + rr;
            grf[orr] = (hc0 == 0 ? 0.f : grf[orr]) + sgrf[(w * kTj + lane) * r + rr];
            if (want_gd) gd[orr] = (hc0 == 0 ? 0.f : gd[orr]) + sgd[(w * kTj + lane) * r + rr];
          }
        }

        // B. columns j = w, w + 8, ... of the tile over its rows i with A[i,j] != 0
        if (want_dv) {
          unsigned col_l = 0;         // lane j's rows i with A[i,j] != 0, as bits
#pragma unroll
          for (int ii = 0; ii < kTi; ++ii) col_l |= ((live_j[ii] >> lane) & 1u) << ii;
#pragma unroll
          for (int m = 0; m < kTj / kTi; ++m) {
            const int jj = w + kTi * m;
            unsigned col = __shfl_sync(kAll, col_l, jj);
            const float dj = dg[jj];
            while (col) {             // warp-uniform
              const int ii = __ffs(col) - 1;
              col &= col - 1;
              const float a = mk[ii * kTj + jj];
              const float* pr = pj + (ii * kTj + jj) * r;
              const float* fr = rfs + (ii * kTj + jj) * r;
#pragma unroll
              for (int q = 0; q < kHl; ++q) {
                if (hc0 + 32 * q >= h) continue;
                const int hl = lane + 32 * q;
                float c;
                const float e = bracket(pr, fr, bs[ii * kHc + hl], vs[jj * kHc + hl], dj, q, c);
                const float m3 = a * c, s = m3 > 0.f ? 1.f : kLeak;
                const float pij = gs[ii * kHc + hl] * a * a * s;
                dv[m][q] += pij;
                sdeg[m] = fmaf(pij, e, sdeg[m]);
              }
            }
          }
        }

        // the j-tile's dv_j / ddeg partials of this block, pushed to the
        // ranks that sum them; summed now, or, after the last j-tile, with
        // the parameter partials below (one barrier for both)
        if (first && want_dv) {
          start();
#pragma unroll
          for (int m = 0; m < kTj / kTi; ++m) {
            const int jj = w + kTi * m;
            if (fl & kV) {
#pragma unroll
              for (int q = 0; q < kHl; ++q) {
                const Dest o = to_v(jj * kHc + lane + 32 * q, rank);
                st_rank(rv + (step & 1) * nv + o.offset, o.rank, dv[m][q]);
              }
            }
            if (fl & kDeg) {
              const float sd = warp_sum(sdeg[m]);
              const Dest o = to_d(jj, rank);
              if (lane == 0) st_rank(rd + (step & 1) * nd + o.offset, o.rank, sd);
            }
          }
          if (!(want_pp && j0 + kTj >= n)) {
            cluster.sync();
            finish_dv(j0, hc0, hc);
            ++step;
          }
        }
      }

      // the pass's outputs: d_a of the block's rows, the parameter partials
      if (first && (fl & kA) && i < rows) {
#pragma unroll
        for (int q = 0; q < kHl; ++q) {
          const int hh = hc0 + lane + 32 * q;
          if (hh < h) d_a[(b * rows + i) * h + hh] = from_f<T>(das[w * kHc + lane + 32 * q]);
        }
      }
      if (!want_pp) continue;
      // rows of the partials: M1d's channels rg0.., M1f's, then (first pass) the bias
      const int prow = 2 * gch + (first ? 1 : 0);
      __syncthreads();                  // the last tile is done with the buffers red aliases
#pragma unroll
      for (int q = 0; q < kHl; ++q) {
        const int hl = lane + 32 * q;
#pragma unroll
        for (int k = 0; k < kRg; ++k) {
          if (k >= gch) break;
          red[(k * kTi + w) * kHc + hl] = accd[k][q];
          red[((gch + k) * kTi + w) * kHc + hl] = accf[k][q];
        }
        if (first) red[(2 * gch * kTi + w) * kHc + hl] = das[w * kHc + hl];
      }
      __syncthreads();
      start();
      float* pb_half = rp + (step & 1) * np;
      const Spread to_p(prow * kHc, cl);
      for (int c = tid; c < prow * kHc; c += kThreads) {
        const int row = c / kHc, hl = c % kHc;
        float s = 0.f;
#pragma unroll
        for (int ww = 0; ww < kTi; ++ww) s += red[(row * kTi + ww) * kHc + hl];
        const Dest o = to_p(c, rank);
        st_rank(pb_half + o.offset, o.rank, s);
      }
      cluster.sync();
      if (first && want_dv) finish_dv(n - 1 - (n - 1) % kTj, hc0, hc);   // the last j-tile's
      // this rank's share of the cluster's parameter partials
      own4(pb_half, prow * kHc, cl, rank, [&](int u, float4 s) {
        wrote = true;
        const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * u + k, row = c / kHc, hh = hc0 + c % kHc;
          if (hh >= h) continue;
          const int64_t col = row < gch       ? static_cast<int64_t>(rg0 + row) * h + hh
                              : row < 2 * gch ? static_cast<int64_t>(r + rg0 + row - gch) * h + hh
                                              : 2 * static_cast<int64_t>(r) * h + hh;
          pp[bp * d.cols4 + col] = v[k];
        }
      });
      ++step;
    }
  }
  // After the last barrier each block reads only its own shared memory, so
  // none waits for another before it leaves; a block that pushed nothing
  // still completes the phase it arrived on.
  start();
  const bool tree_sum = clusters > 1 && want_dv;
  if (!want_pp && !tree_sum) return;

  // the sums over a tree's clusters and over trees: every block, its share
  // of the cluster partials out, takes one increment of its (tree, rank)
  // counter and one of the global one; the last ones take the sums
  if (wrote) __threadfence();           // this thread's cluster partials, GPU-wide
  __syncthreads();
  if (tid == 0) {
    last_in_tree = tree_sum && atomicAdd(counter + 1 + b * cl + rank, 1u) == clusters - 1u;
    last_block = want_pp && atomicAdd(counter, 1u) == gridDim.x - 1;
    // acquire: the other blocks' partials, then the barrier
    if (last_in_tree || last_block) __threadfence();
  }
  __syncthreads();
  if (last_in_tree) {
    // this rank's columns of the tree's dv_j and ddeg (those finish_dv
    // wrote: Spread's share of each j-tile and h chunk), summed over the
    // tree's clusters in order, kBatch elements a thread at a time so that
    // their loads overlap
    const int64_t nh = static_cast<int64_t>(n) * h;
    const int jt = (n + kTj - 1) / kTj;
    if (fl & kV) {
      const int per = 4 * ((kTj * kHc / 4 + cl - 1) / cl), total = n_hc * jt * per;
      for (int x0 = tid; x0 < total; x0 += kBatch * kThreads) {
        int64_t off[kBatch];
        float s[kBatch] = {};
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int x = x0 + k * kThreads, y = x % (jt * per), e = rank * per + y % per;
          const int j = y / per * kTj + e / kHc, hh = x / (jt * per) * kHc + e % kHc;
          const bool ok = x < total && e < kTj * kHc && j < n && hh < h;
          off[k] = ok ? static_cast<int64_t>(j) * h + hh : -1;
        }
        for (int q = 0; q < clusters; ++q) {
          const float* src = pv + (b * clusters + q) * nh;
          float v[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) v[k] = off[k] >= 0 ? __ldcg(src + off[k]) : 0.f;
#pragma unroll
          for (int k = 0; k < kBatch; ++k) s[k] += v[k];
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (off[k] >= 0) d_v[b * nh + off[k]] = from_f<T>(s[k]);
      }
    }
    if (fl & kDeg) {
      const int per = 4 * ((kTj / 4 + cl - 1) / cl);
      for (int x = tid; x < jt * per; x += kThreads) {
        const int e = rank * per + x % per, j = x / per * kTj + e;
        if (e >= kTj || j >= n) continue;
        float s = 0.f;
        for (int q = 0; q < clusters; ++q) s += __ldcg(pdeg + (b * clusters + q) * n + j);
        d_deg[b * n + j] = from_f<T>(s);
      }
    }
    if (tid == 0) counter[1 + b * cl + rank] = 0u;   // ready for the next launch on this stream
  }
  if (!last_block) return;
  const int c4 = d.cols4 / 4;
  const int parts = d.batch * clusters;   // rows of the cluster partials
  const int64_t cols = static_cast<int64_t>(2 * r + 1) * h, rh = static_cast<int64_t>(r) * h;
  const float4* pp4 = reinterpret_cast<const float4*>(pp);
  float4* red4 = reinterpret_cast<float4*>(smem);
  for (int cb = 0; cb < c4; cb += kThreads) {
    // columns [cb, cb + width) of float4s; stripe s sums the rows s, s + S, ...
    const int width = c4 - cb < kThreads ? c4 - cb : kThreads, stripes = kThreads / width;
    const int stripe = tid / width, c = cb + tid % width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (stripe < stripes) {
      for (int b0 = stripe; b0 < parts; b0 += kBatch * stripes) {
        float4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int bb = b0 + k * stripes;
          v[k] = bb < parts ? __ldcg(pp4 + static_cast<int64_t>(bb) * c4 + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) add4(acc, v[k]);
      }
    }
    __syncthreads();
    if (stripe < stripes) red4[stripe * width + tid % width] = acc;
    __syncthreads();
    if (tid < width) {
      float4 s = red4[tid];
      for (int st = 1; st < stripes; ++st) add4(s, red4[st * width + tid]);
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t col = 4 * static_cast<int64_t>(cb + tid) + k;
        if (col >= cols) break;
        if (col < rh) {
          if (fl & kM1d) d_m1d[col] = from_f<T>(v[k]);
        } else if (col < 2 * rh) {
          if (fl & kM1f) d_m1f[col - rh] = from_f<T>(v[k]);
        } else if (fl & kBias) {
          d_bias[col - 2 * rh] = from_f<T>(v[k]);
        }
      }
    }
  }
  if (tid == 0) *counter = 0u;          // ready for the next launch on this stream
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
__global__ void __launch_bounds__(kThreads) motif_l3_grad_contract_kernel(
    const T* __restrict__ adj, const T* __restrict__ phi, const float* __restrict__ gd,
    const float* __restrict__ grf, const float* __restrict__ loc, T* __restrict__ d_adj,
    T* __restrict__ d_phi, const Dims d) {
  __shared__ float xs[kTo][kTo + 1], ys[kTo][kTo + 1];
  const int n = d.n, rows = d.rows, r = d.r, fl = d.flags;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_tiles = (n + kTo - 1) / kTo;
  const int m0 = static_cast<int>(blockIdx.x % row_tiles) * kTo;
  const int64_t b = blockIdx.x / row_tiles;

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
                       ? grf[((b * rows + l / r) * n + m0 + jj) * r + l % r] : 0.f;
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
        if (j >= d.row0 && j < d.row0 + rows) v += loc[(b * rows + j - d.row0) * n + k];
        d_adj[(b * n + j) * n + k] = from_f<T>(v);
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
              return m0 + ii < rows && j < n ? grf[((b * rows + m0 + ii) * n + j) * r + rr]
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
          d_phi[o] = from_f<T>(gd[o] + acc[m]);
        }
      }
    }
  }
}

struct Ptrs {
  const void *adj, *phi, *a_i, *v_j, *deg, *m1d, *m1f, *bias, *g;
  void *d_adj, *d_phi, *d_a, *d_v, *d_deg, *d_m1d, *d_m1f, *d_bias;
  float *gd, *grf, *loc, *pdeg, *pv, *pp;
  unsigned* counter;
};

// The model's shapes (N <= 32, h <= 64, R = 1) take an instance of their
// own, with one h column per lane where h <= 32 (see the header).
constexpr bool model_instance(int n, int r, int h) {
  return n <= 32 && r == 1 && h <= 64;
}

template <typename T, int kTk, int kHl, bool kOneH, int kRg>
int launch(const Ptrs& p, const Dims& d, int cluster, void* stream) {
  constexpr int kHc = 32 * kHl;
  const size_t smem = sizeof(float) * main_smem_floats<kTk, kHc>(d.r);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(d.batch) * d.clusters * cluster;
  const int row_tiles = (d.n + kTo - 1) / kTo;
  const int64_t contract_blocks = static_cast<int64_t>(d.batch) * row_tiles;
  if (blocks > 0x7fffffffLL || contract_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = std::is_same<T, float>::value && d.n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.adj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.phi) % 16 == 0;
  const auto kernel = motif_l3_grad_kernel<T, kTk, kHl, kOneH, kRg>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(p.adj), static_cast<const T*>(p.phi),
      static_cast<const T*>(p.a_i), static_cast<const T*>(p.v_j), static_cast<const T*>(p.deg),
      static_cast<const T*>(p.m1d), static_cast<const T*>(p.m1f), static_cast<const T*>(p.bias),
      static_cast<const T*>(p.g), static_cast<T*>(p.d_a), static_cast<T*>(p.d_v),
      static_cast<T*>(p.d_deg), static_cast<T*>(p.d_m1d), static_cast<T*>(p.d_m1f),
      static_cast<T*>(p.d_bias), p.gd, p.grf, p.loc, p.pdeg, p.pv, p.pp, p.counter, d, vec);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || !(d.flags & (kAdj | kPhi))) return static_cast<int>(err);
  motif_l3_grad_contract_kernel<T><<<static_cast<unsigned>(contract_blocks), kThreads, 0, s>>>(
      static_cast<const T*>(p.adj), static_cast<const T*>(p.phi), p.gd, p.grf, p.loc,
      static_cast<T*>(p.d_adj), static_cast<T*>(p.d_phi), d);
  return static_cast<int>(cudaGetLastError());
}

// The instances: the model's (k-chunks of 32, one j-tile, one h chunk,
// R = 1; one h column per lane where h <= 32, two beyond), and one generic
// instance for every other shape (k-chunks of 128, the forward's; two h
// columns per lane, h chunks, j-tiles and R at run time).
template <typename T>
int launch(const Ptrs& p, const Dims& d, int cluster, void* stream) {
  if (!model_instance(d.n, d.r, d.h))
    return launch<T, 128, 2, false, kRgMax>(p, d, cluster, stream);
  return d.h <= 32 ? launch<T, 32, 1, true, 1>(p, d, cluster, stream)
                   : launch<T, 32, 2, true, 1>(p, d, cluster, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Inputs as motif_level3_launch takes
// them, g [B,rows,H] the gradient of nt; the gradients in the inputs'
// shapes and dtype (d_a the window's rows), null where ``flags`` does not
// ask (bit k: the k-th of adj, phi, a_i, v_j, deg, m1d, m1f, bias).  The
// launch plan (motif_level3.py, motif_level3_backward_plan): tiles =
// ceil(rows / 8), clusters = 1 where tiles <= 4 else ceil(tiles / 2), of
// cluster = ceil(tiles / clusters) blocks, h_chunk = 32 in the model's
// instance where
// H <= 32 else 64, cols4 = (2R+1)H rounded up to 4; a plan that differs is
// refused with cudaErrorInvalidValue.  f32 scratch, each needed only for the
// flags named: gd [B,rows,N,R] (phi), grf [B,rows,N,R] (adj or phi), loc
// [B,rows,N] (adj), pdeg [B,clusters,N] (deg), pv [B,clusters,N,H] (v_j,
// where clusters > 1), pp [B,clusters,cols4] (m1d, m1f or bias), and the
// counters (the parameters, or v_j or deg where clusters > 1): 1 + B
// cluster unsigned where clusters > 1 (the sums over trees, then one per
// tree and rank), else 1, 0 before the launch and left 0 after it, used by
// one stream at a time.  All contiguous.  One launch on ``stream``, two where adj or phi is
// asked.
extern "C" int motif_level3_backward_launch(
    const void* adj, const void* phi, const void* a_i, const void* v_j, const void* deg,
    const void* m1d, const void* m1f, const void* bias, const void* g, void* d_adj,
    void* d_phi, void* d_a, void* d_v, void* d_deg, void* d_m1d, void* d_m1f, void* d_bias,
    float* gd, float* grf, float* loc, float* pdeg, float* pv, float* pp, unsigned* counter,
    int batch, int n, int row0, int rows, int r, int h, int tiles, int clusters, int cluster,
    int h_chunk, int cols4, int flags, int dtype, void* stream) {
  const int want_tiles = (rows + kTi - 1) / kTi;
  const int want_clusters =
      want_tiles > kMaxCluster ? (want_tiles + kSplitCluster - 1) / kSplitCluster : 1;
  const int want_cluster = want_tiles > 0 ? (want_tiles + want_clusters - 1) / want_clusters : 1;
  if (row0 < 0 || rows < 0 || row0 + rows > n || r < 0 || h < 0 || tiles != want_tiles ||
      clusters != want_clusters || cluster != want_cluster ||
      h_chunk != (model_instance(n, r, h) && h <= 32 ? 32 : 64) ||
      cols4 != ((2 * r + 1) * h + 3) / 4 * 4 || (flags & ~255) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pp_asked = flags & (kM1d | kM1f | kBias);
  const bool tree_sum = clusters > 1 && (flags & (kV | kDeg));
  const bool missing =
      ((flags & kAdj) && (!d_adj || !grf || !loc)) || ((flags & kPhi) && (!d_phi || !gd || !grf)) ||
      ((flags & kA) && !d_a) || ((flags & kV) && (!d_v || (clusters > 1 && !pv))) ||
      ((flags & kDeg) && (!d_deg || !pdeg)) || ((flags & kM1d) && !d_m1d) ||
      ((flags & kM1f) && !d_m1f) || ((flags & kBias) && !d_bias) || (pp_asked && !pp) ||
      ((pp_asked || tree_sum) && !counter);
  if (missing) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || rows == 0 || h == 0 || flags == 0) return 0;
  const Ptrs p{adj, phi, a_i, v_j, deg, m1d, m1f, bias, g,
               d_adj, d_phi, d_a, d_v, d_deg, d_m1d, d_m1f, d_bias,
               gd, grf, loc, pdeg, pv, pp, counter};
  const Dims d{batch, n, row0, rows, r, h, tiles, clusters, cols4, flags};
  if (dtype == 0) return launch<float>(p, d, cluster, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, d, cluster, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
