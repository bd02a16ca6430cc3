// motif_level4_backward: the gradient of motif_level4 (csrc/motif_level4.cu)
// for g = dL/dtm, in one launch.  With z as the forward forms it and
// lrelu'(x) = 1 for x > 0, 0.2 otherwise (PyTorch's leaky_relu backward):
//
//   P[i,j,k,:]  = (M[j,k] g[i,j,:]) lrelu'(z[i,j,k,:]) (M[i,j] M[j,k])
//   dpu[i,j]    = sum_k deg[k] P[i,j,k]        dalpha[i,k] = sum_j P[i,j,k]
//   dbeta[j,k]  = sum_{i of the window} P[i,j,k]   dgamma[k] = sum_{i,j} P[i,j,k]
//
// The masks and deg are data and take no gradient.  P vanishes off the
// tree's paths (M[i,j] M[j,k] = 0), so each sum runs over paths only.
//
// It replaces autograd through the plain chain (the broadcast adds, the
// mask product, lrelu and the k-sum's matmul), which kept m4 [B,n,N,N,h]
// for the backward and passed over tensors of its size about six times.
//
// What bounds it on an H100.  Bytes: dpu, dalpha and dbeta written whole
// ([B,n,N,h] twice and [B,N,N,h]: 150 MB at protein's layer 1, 300 MB at
// layer 2, ~45 / ~90 us at 3.35 TB/s), g, pu, alpha, beta and gamma read on
// the paths only.  Operations: a few tens of FLOP per path and column.  So
// it is bound by its writes and by the chain of dependent loads that
// finding the paths takes.
//
// Design: every gradient element has one owner lane that gathers its sum
// over its index set in a fixed order, so the result is the same bit for
// bit from run to run and no float atomics are used.  One warp owns one
// output row, a lane one column h (h > 32 walks chunks of 32); a tree's
// 2 n + 2 N rows are units of the grid:
//   * dpu[b,i]    (n units): for each j with M[i,j] != 0 (a ballot over
//     M[i, j-chunk]), sum over k of row j (ballots over M[j, k-chunk]),
//     k ascending;
//   * dalpha[b,i] (n units): per chunk of 32 k, lane k marks whether some
//     j of row i has M[j,k] != 0; for each marked k, sum over those j,
//     ascending;
//   * dbeta[b,j]  (N units): for each k with M[j,k] != 0, sum over the i of
//     the window with M[i,j] != 0 (ballots over column j of mask_i),
//     ascending;
//   * dgamma[b,k] (N units): sum over j with M[j,k] != 0 (column k of M),
//     then over i with M[i,j] != 0, both ascending.
// Each unit writes zeros for the entries no path reaches, on consecutive
// addresses.  Every P is recomputed where it is summed (four times a path).
#include "motif_level4.cuh"

namespace {

struct Args {
  const void* mask_i;  // [B, rows, N]
  const void* mask;    // [B, N, N]
  const void* deg;     // [B, N]
  const void* pu;      // [B, rows, N, h]
  const void* alpha;   // [B, rows, N, h]
  const void* beta;    // [B, N, N, h]
  const void* gamma;   // [B, N, h]
  const void* grad;    // [B, rows, N, h]
  void* dpu;
  void* dalpha;
  void* dbeta;
  void* dgamma;
};

template <typename T>
struct Tree {
  const T *mi, *mb, *db, *pu, *al, *be, *ga, *g;
  int n, rows, h;
  int64_t nh;

  // P[i,j,k,h] for the lane's column hh of a path (M[i,j], M[j,k] given)
  __device__ __forceinline__ float p(int i, int j, int64_t k, int hh, float mij, float mjk,
                                     float dk) const {
    const int64_t ij = (static_cast<int64_t>(i) * n + j) * h + hh;
    const int64_t ik = (static_cast<int64_t>(i) * n + k) * h + hh;
    const int64_t jk = (static_cast<int64_t>(j) * n + k) * h + hh;
    const float z = level4_z(dk, to_f(pu[ij]), to_f(al[ik]), to_f(be[jk]), to_f(ga[k * h + hh]),
                             __fmul_rn(mij, mjk));
    const float d = __fmul_rn(mjk, to_f(g[ij]));
    return __fmul_rn(z > 0.f ? d : __fmul_rn(d, kLeak), __fmul_rn(mij, mjk));
  }
};

// dpu[b,i] = sum_k deg[k] P[i,j,k] for each j, as the forward walks its row.
template <typename T>
__device__ void dpu_row(const Tree<T>& t, int i, T* out, int lane) {
  const T* mi = t.mi + static_cast<int64_t>(i) * t.n;
  for (int j0 = 0; j0 < t.n; j0 += 32) {
    float mij_l;
    unsigned live = live_of(mi, 1, j0, t.n, lane, &mij_l);
    zero_dead(out, j0, t.n, t.h, live, lane);
    while (live) {
      const int jj = __ffs(live) - 1;
      live &= live - 1;
      const int j = j0 + jj;
      const float mij = __shfl_sync(kAll, mij_l, jj);
      const T* mj = t.mb + static_cast<int64_t>(j) * t.n;
      for (int h0 = 0; h0 < t.h; h0 += 32) {
        const int hh = h0 + lane;
        float acc = 0.f;
        for (int k0 = 0; k0 < t.n; k0 += 32) {
          float mjk_l;
          unsigned ks = live_of(mj, 1, k0, t.n, lane, &mjk_l);
          const float dk_l = k0 + lane < t.n ? to_f(t.db[k0 + lane]) : 0.f;
          while (ks) {
            const int kk = __ffs(ks) - 1;
            ks &= ks - 1;
            const float mjk = __shfl_sync(kAll, mjk_l, kk), dk = __shfl_sync(kAll, dk_l, kk);
            if (hh < t.h) acc = fmaf(dk, t.p(i, j, k0 + kk, hh, mij, mjk, dk), acc);
          }
        }
        if (hh < t.h) out[static_cast<int64_t>(j) * t.h + hh] = from_f<T>(acc);
      }
    }
  }
}

// dalpha[b,i,k] = sum_j P[i,j,k] over the j of row i with M[j,k] != 0.
template <typename T>
__device__ void dalpha_row(const Tree<T>& t, int i, T* out, int lane) {
  const T* mi = t.mi + static_cast<int64_t>(i) * t.n;
  for (int k0 = 0; k0 < t.n; k0 += 32) {
    // lane k: does a path i-j-k reach it?
    bool reached = false;
    for (int j0 = 0; j0 < t.n; j0 += 32) {
      float mij_l;
      unsigned live = live_of(mi, 1, j0, t.n, lane, &mij_l);
      while (live) {
        const int j = j0 + __ffs(live) - 1;
        live &= live - 1;
        const int k = k0 + lane;
        if (k < t.n && to_f(t.mb[static_cast<int64_t>(j) * t.n + k]) != 0.f) reached = true;
      }
    }
    const float dk_l = k0 + lane < t.n ? to_f(t.db[k0 + lane]) : 0.f;
    unsigned ks = __ballot_sync(kAll, reached);
    zero_dead(out, k0, t.n, t.h, ks, lane);
    while (ks) {
      const int kk = __ffs(ks) - 1;
      ks &= ks - 1;
      const int k = k0 + kk;
      const float dk = __shfl_sync(kAll, dk_l, kk);
      for (int h0 = 0; h0 < t.h; h0 += 32) {
        const int hh = h0 + lane;
        float acc = 0.f;
        for (int j0 = 0; j0 < t.n; j0 += 32) {
          float mij_l;
          unsigned live = live_of(mi, 1, j0, t.n, lane, &mij_l);
          while (live) {
            const int jj = __ffs(live) - 1;
            live &= live - 1;
            const int j = j0 + jj;
            const float mij = __shfl_sync(kAll, mij_l, jj);
            const float mjk = to_f(t.mb[static_cast<int64_t>(j) * t.n + k]);
            if (mjk != 0.f && hh < t.h) acc += t.p(i, j, k, hh, mij, mjk, dk);
          }
        }
        if (hh < t.h) out[static_cast<int64_t>(k) * t.h + hh] = from_f<T>(acc);
      }
    }
  }
}

// The sum over the window's i with M[i,j] != 0 of P[i,j,k] (column j of
// mask_i, ascending), added to acc in that order.
template <typename T>
__device__ __forceinline__ float sum_over_i(const Tree<T>& t, int j, int k, int hh, float mjk,
                                            float dk, float acc, int lane) {
  for (int i0 = 0; i0 < t.rows; i0 += 32) {
    float mij_l;
    unsigned is = live_of(t.mi + j, t.n, i0, t.rows, lane, &mij_l);
    while (is) {
      const int ii = __ffs(is) - 1;
      is &= is - 1;
      const float mij = __shfl_sync(kAll, mij_l, ii);
      if (hh < t.h) acc += t.p(i0 + ii, j, k, hh, mij, mjk, dk);
    }
  }
  return acc;
}

// dbeta[b,j,k] = sum_i P[i,j,k] for each k with M[j,k] != 0.
template <typename T>
__device__ void dbeta_row(const Tree<T>& t, int j, T* out, int lane) {
  const T* mj = t.mb + static_cast<int64_t>(j) * t.n;
  for (int k0 = 0; k0 < t.n; k0 += 32) {
    float mjk_l;
    unsigned ks = live_of(mj, 1, k0, t.n, lane, &mjk_l);
    const float dk_l = k0 + lane < t.n ? to_f(t.db[k0 + lane]) : 0.f;
    zero_dead(out, k0, t.n, t.h, ks, lane);
    while (ks) {
      const int kk = __ffs(ks) - 1;
      ks &= ks - 1;
      const int k = k0 + kk;
      const float mjk = __shfl_sync(kAll, mjk_l, kk), dk = __shfl_sync(kAll, dk_l, kk);
      for (int h0 = 0; h0 < t.h; h0 += 32) {
        const int hh = h0 + lane;
        const float acc = sum_over_i(t, j, k, hh, mjk, dk, 0.f, lane);
        if (hh < t.h) out[static_cast<int64_t>(k) * t.h + hh] = from_f<T>(acc);
      }
    }
  }
}

// dgamma[b,k] = sum over j with M[j,k] != 0, then over i, of P[i,j,k].
template <typename T>
__device__ void dgamma_row(const Tree<T>& t, int k, T* out, int lane) {
  const float dk = to_f(t.db[k]);
  for (int h0 = 0; h0 < t.h; h0 += 32) {
    const int hh = h0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < t.n; j0 += 32) {
      float mjk_l;
      unsigned js = live_of(t.mb + k, t.n, j0, t.n, lane, &mjk_l);
      while (js) {
        const int jj = __ffs(js) - 1;
        js &= js - 1;
        acc = sum_over_i(t, j0 + jj, k, hh, __shfl_sync(kAll, mjk_l, jj), dk, acc, lane);
      }
    }
    if (hh < t.h) out[hh] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
motif_level4_grad_kernel(Args a, int64_t units, int n, int rows, int h) {
  const int lane = threadIdx.x % 32;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;               // warp-uniform
  const int per_tree = 2 * rows + 2 * n;
  const int64_t b = u / per_tree;
  int r = static_cast<int>(u % per_tree);
  const int64_t nh = static_cast<int64_t>(n) * h;
  const Tree<T> t{static_cast<const T*>(a.mask_i) + b * rows * n,
                  static_cast<const T*>(a.mask) + b * n * n,
                  static_cast<const T*>(a.deg) + b * n,
                  static_cast<const T*>(a.pu) + b * rows * nh,
                  static_cast<const T*>(a.alpha) + b * rows * nh,
                  static_cast<const T*>(a.beta) + b * n * nh,
                  static_cast<const T*>(a.gamma) + b * nh,
                  static_cast<const T*>(a.grad) + b * rows * nh,
                  n, rows, h, nh};
  if (r < rows) {
    dpu_row(t, r, static_cast<T*>(a.dpu) + (b * rows + r) * nh, lane);
    return;
  }
  r -= rows;
  if (r < rows) {
    dalpha_row(t, r, static_cast<T*>(a.dalpha) + (b * rows + r) * nh, lane);
    return;
  }
  r -= rows;
  if (r < n) {
    dbeta_row(t, r, static_cast<T*>(a.dbeta) + (b * n + r) * nh, lane);
    return;
  }
  r -= n;
  dgamma_row(t, r, static_cast<T*>(a.dgamma) + (b * n + r) * h, lane);
}

template <typename T>
int launch(const Args& a, int batch, int n, int rows, int h, void* stream) {
  if (batch < 0 || n < 0 || rows < 0 || rows > n || h < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = static_cast<int64_t>(batch) * (2 * rows + 2 * n);
  if (units == 0 || h == 0) return 0;
  const int64_t blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  motif_level4_grad_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a, units, n, rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The inputs as motif_level4_launch takes
// them and grad [B,rows,N,H]; dpu, dalpha [B,rows,N,H], dbeta [B,N,N,H],
// dgamma [B,N,H], each written whole.  All contiguous.
extern "C" int motif_level4_backward_launch(const void* mask_i, const void* mask,
                                            const void* deg, const void* pu,
                                            const void* alpha, const void* beta,
                                            const void* gamma, const void* grad, void* dpu,
                                            void* dalpha, void* dbeta, void* dgamma,
                                            int batch, int n, int rows, int h, int dtype,
                                            void* stream) {
  const Args a{mask_i, mask, deg, pu, alpha, beta, gamma, grad, dpu, dalpha, dbeta, dgamma};
  if (dtype == 0) return launch<float>(a, batch, n, rows, h, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, n, rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
