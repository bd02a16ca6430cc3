// Native data-path library of the PyTorch port: the spanning-tree sampler
// and pairwise distances of the JAX package's native/sndkern.cpp, kept
// line for line so that both draw the same trees for the same seed.
//
// The accelerator owns all tensor compute; what remains on the host is graph-shaped
// preparation work that the reference does in slow Python loops:
//   * random spanning-tree sampling per (graph, sample) pair
//     (reference input_data.py:18-38, 71-83: scipy MST in a Python loop)
//   * batched pairwise Euclidean distances
//     (reference input_data.py:145-151: a triple Python loop)
// Both are implemented here with a simple thread pool over graphs.
//
// Exposed as a C ABI consumed via ctypes (snd_vae_tpu_torch/utils/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <random>
#include <thread>
#include <vector>

namespace {

// Kruskal with union-find over randomly permuted edges == MST with i.i.d.
// random edge weights, matching the reference's scipy_spanning_tree sampling
// distribution (random weights in [1,2), input_data.py:20).
struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  bool unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) return false;
    parent[ra] = rb;
    return true;
  }
};

void sample_tree(const double* adj, int64_t n, uint64_t seed, double* out) {
  // collect upper-triangle edges
  std::vector<std::pair<int32_t, int32_t>> edges;
  edges.reserve(static_cast<size_t>(n) * 4);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = i + 1; j < n; ++j)
      if (adj[i * n + j] != 0.0)
        edges.emplace_back(static_cast<int32_t>(i), static_cast<int32_t>(j));

  std::mt19937_64 rng(seed);
  std::shuffle(edges.begin(), edges.end(), rng);

  UnionFind uf(static_cast<int32_t>(n));
  int64_t taken = 0;
  for (const auto& e : edges) {
    if (uf.unite(e.first, e.second)) {
      out[static_cast<int64_t>(e.first) * n + e.second] = 1.0;
      out[static_cast<int64_t>(e.second) * n + e.first] = 1.0;
      if (++taken == n - 1) break;
    }
  }
}

template <typename Fn>
void parallel_for(int64_t count, Fn&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t workers = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, count));
  if (workers == 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int64_t w = 0; w < workers; ++w) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// adj [G,N,N] row-major -> out [G,S,N,N]; returns 0 on success.
int snd_sample_spanning_trees(const double* adj, int64_t G, int64_t N,
                              int64_t S, uint64_t seed, double* out) {
  if (G < 0 || N <= 0 || S <= 0) return 1;
  parallel_for(G * S, [&](int64_t idx) {
    int64_t g = idx / S, s = idx % S;
    // splitmix-style per-task seed so results are deterministic regardless
    // of thread scheduling
    uint64_t z = seed + 0x9E3779B97F4A7C15ull * (uint64_t)(idx + 1);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    sample_tree(adj + g * N * N, N, z ^ (z >> 31), out + (g * S + s) * N * N);
  });
  return 0;
}

// coords [G,N,D] -> out [G,N,N] Euclidean distances; returns 0 on success.
int snd_pairwise_distances(const double* coords, int64_t G, int64_t N,
                           int64_t D, double* out) {
  if (G < 0 || N <= 0 || D <= 0) return 1;
  parallel_for(G, [&](int64_t g) {
    const double* c = coords + g * N * D;
    double* o = out + g * N * N;
    for (int64_t i = 0; i < N; ++i) {
      o[i * N + i] = 0.0;
      for (int64_t j = i + 1; j < N; ++j) {
        double acc = 0.0;
        for (int64_t d = 0; d < D; ++d) {
          double diff = c[i * D + d] - c[j * D + d];
          acc += diff * diff;
        }
        double dist = std::sqrt(acc);
        o[i * N + j] = dist;
        o[j * N + i] = dist;
      }
    }
  });
  return 0;
}

}  // extern "C"
