// motif_level4: level 4 of the fourth-order spatial-motif conv and its masked
// k-sum, without the [B,n,N,N,h] tensor m4 (snd_vae_tpu_torch/nn/
// spatial_conv.py, level3_rows; JAX snd_vae_tpu/nn/spatial_conv.py:401-562):
//
//   z[i,j,k,:] = M[i,j] M[j,k] (deg[k] pu[i,j,:] + alpha[i,k,:] + beta[j,k,:] + gamma[k,:])
//   tm[i,j,:]  = sum_k M[j,k] lrelu(z[i,j,k,:]),   lrelu(x) = x > 0 ? x : 0.2 x
//
// for the rows i of a window (M[i,:] from mask_i [B,n,N]; all N rows by
// default, a rank's rows under the model axis, one block under block_rows),
// with M [B,N,N] whole.  f32 or bf16 tensors, f32 arithmetic; tm has the
// inputs' dtype.
//
// It replaces no TPU kernel: the JAX package leaves level 4 to XLA, and the
// port ran it as PyTorch ops that wrote m4 whole (2.5 GB at protein's layer
// 1, 5 GB at layer 2) and passed over it about seven times.
//
// What bounds it on an H100.  z is 0 wherever M[i,j] M[j,k] = 0, and
// lrelu(0) = 0, so only the tree's paths i-j-k count: sum_j deg_j^2 of the
// N^3 (i,j,k) of a tree, 0.25% at protein's N = 50.  Bytes: tm written
// whole ([B,n,N,h], 50 MB at protein's layer 1 (B = 500 trees, h = 10),
// 100 MB at layer 2: ~15 / ~30 us at 3.35 TB/s), the masks read, and pu,
// alpha, beta and gamma read only on the paths, a few MB.  Operations: ~10
// FLOP per path and column, a few MFLOP.  So it is bound by writing tm, and
// by the chain of dependent loads that finding the paths takes.
//
// Design.  One warp owns one row (b, i) of tm, a lane one column h (h > 32
// walks chunks of 32).  For each chunk of 32 j, a ballot over M[i, j-chunk]
// lists the j with M[i,j] != 0; the warp writes zeros for the others on
// consecutive addresses, and for each listed j a ballot over M[j, k-chunk]
// lists its k, in ascending order, so each lane sums its column of tm over
// the k of j's row in a fixed order: no atomics, no shared memory, no
// bound on N.  A dense mask (the fully_connected variant) lists every j
// and k.  The masks and the node terms are read through the read-only path;
// a tree's mask (10 KB at N = 50) stays in L1 for the block's 8 rows.
// (A block a tree with the tree's masks staged in shared memory ran 20%
// slower forward and no faster backward: the loads of the node terms on
// the paths, not the ballots, make the chain.)
#include "motif_level4.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
motif_level4_kernel(const T* __restrict__ mask_i, const T* __restrict__ mask,
                    const T* __restrict__ deg, const T* __restrict__ pu,
                    const T* __restrict__ alpha, const T* __restrict__ beta,
                    const T* __restrict__ gamma, T* __restrict__ tm, int64_t units, int n,
                    int rows, int h) {
  const int lane = threadIdx.x % 32;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;               // warp-uniform
  const int64_t b = u / rows;
  const int64_t nh = static_cast<int64_t>(n) * h;
  const T* mi = mask_i + u * n;         // M[i, :]
  const T* mb = mask + b * n * n;       // M[b]
  const T* db = deg + b * n;
  const T* pi = pu + u * nh;            // pu[b, i]     [N, h]
  const T* ai = alpha + u * nh;         // alpha[b, i]  [N, h]
  const T* bb = beta + b * n * nh;      // beta[b]      [N, N, h]
  const T* gb = gamma + b * nh;         // gamma[b]     [N, h]
  T* out = tm + u * nh;                 // tm[b, i]     [N, h]

  for (int j0 = 0; j0 < n; j0 += 32) {
    float mij_l;
    unsigned live = live_of(mi, 1, j0, n, lane, &mij_l);
    zero_dead(out, j0, n, h, live, lane);
    while (live) {                      // warp-uniform
      const int jj = __ffs(live) - 1;
      live &= live - 1;
      const int j = j0 + jj;
      const float mij = __shfl_sync(kAll, mij_l, jj);
      const T* mj = mb + static_cast<int64_t>(j) * n;     // M[j, :]
      const T* bj = bb + static_cast<int64_t>(j) * nh;    // beta[b, j]
      for (int h0 = 0; h0 < h; h0 += 32) {
        const int hh = h0 + lane;
        const bool on = hh < h;
        const float p = on ? to_f(pi[static_cast<int64_t>(j) * h + hh]) : 0.f;
        float acc = 0.f;
        for (int k0 = 0; k0 < n; k0 += 32) {
          float mjk_l;
          unsigned ks = live_of(mj, 1, k0, n, lane, &mjk_l);
          const float dk_l = k0 + lane < n ? to_f(db[k0 + lane]) : 0.f;
          while (ks) {                  // warp-uniform
            const int kk = __ffs(ks) - 1;
            ks &= ks - 1;
            const int64_t k = k0 + kk;
            const float mjk = __shfl_sync(kAll, mjk_l, kk), dk = __shfl_sync(kAll, dk_l, kk);
            if (on) {
              const float z = level4_z(dk, p, to_f(ai[k * h + hh]), to_f(bj[k * h + hh]),
                                       to_f(gb[k * h + hh]), __fmul_rn(mij, mjk));
              acc = fmaf(mjk, z > 0.f ? z : __fmul_rn(z, kLeak), acc);
            }
          }
        }
        if (on) out[static_cast<int64_t>(j) * h + hh] = from_f<T>(acc);
      }
    }
  }
}

template <typename T>
int launch(const void* mask_i, const void* mask, const void* deg, const void* pu,
           const void* alpha, const void* beta, const void* gamma, void* tm, int batch, int n,
           int rows, int h, void* stream) {
  if (batch < 0 || n < 0 || rows < 0 || rows > n || h < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = static_cast<int64_t>(batch) * rows;
  if (units == 0 || n == 0 || h == 0) return 0;
  const int64_t blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  motif_level4_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(mask_i), static_cast<const T*>(mask), static_cast<const T*>(deg),
      static_cast<const T*>(pu), static_cast<const T*>(alpha), static_cast<const T*>(beta),
      static_cast<const T*>(gamma), static_cast<T*>(tm), units, n, rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous: mask_i [B,rows,N],
// mask [B,N,N], deg [B,N], pu [B,rows,N,H], alpha [B,rows,N,H],
// beta [B,N,N,H], gamma [B,N,H], tm [B,rows,N,H]; their strides follow from
// the shapes.
extern "C" int motif_level4_launch(const void* mask_i, const void* mask, const void* deg,
                                   const void* pu, const void* alpha, const void* beta,
                                   const void* gamma, void* tm, int batch, int n, int rows,
                                   int h, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(mask_i, mask, deg, pu, alpha, beta, gamma, tm, batch, n, rows, h,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask_i, mask, deg, pu, alpha, beta, gamma, tm, batch, n,
                                 rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
