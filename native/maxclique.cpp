// Exact maximum-clique solver — native host-side component.
//
// Equivalent of the PMC library usage in the reference
// (/root/reference/teaser/src/graph.cc:12-125: k-core bounds, heuristic
// lower bound, exact branch-and-bound with coloring bounds; Rossi et al.,
// "Parallel Maximum Clique Algorithms with Applications to Network
// Analysis", SIAM J. Sci. Comput. 2015). Branch-and-bound search does not
// map to dense device kernels, so — like the reference — the exact
// stage runs on the host, here as a fresh implementation:
//
//   1. k-core decomposition (peeling) for an upper bound + vertex order,
//   2. greedy clique from core ordering for a lower bound,
//   3. branch-and-bound over core-ordered vertices with greedy-coloring
//      pruning and a wall-clock budget, parallelized over root vertices
//      with OpenMP-free std::thread workers sharing an atomic best.
//
// Exposed with a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Graph {
  int n;
  std::vector<std::vector<int>> adj;     // sorted adjacency lists
  std::vector<std::vector<uint8_t>> mat; // dense adjacency for O(1) tests

  bool connected(int a, int b) const { return mat[a][b] != 0; }
};

// k-core peeling; returns core number per vertex.
std::vector<int> core_numbers(const Graph& g) {
  std::vector<int> deg(g.n), core(g.n, 0);
  for (int v = 0; v < g.n; ++v) deg[v] = static_cast<int>(g.adj[v].size());
  // bucket sort by degree
  int maxd = 0;
  for (int d : deg) maxd = std::max(maxd, d);
  std::vector<std::vector<int>> bucket(maxd + 1);
  for (int v = 0; v < g.n; ++v) bucket[deg[v]].push_back(v);
  std::vector<uint8_t> removed(g.n, 0);
  std::vector<int> curdeg = deg;
  int k = 0;
  for (int d = 0; d <= maxd; ++d) {
    for (size_t bi = 0; bi < bucket[d].size(); ++bi) {
      int v = bucket[d][bi];
      if (removed[v] || curdeg[v] > d) continue;
      removed[v] = 1;
      k = std::max(k, curdeg[v]);
      core[v] = k;
      for (int u : g.adj[v]) {
        if (!removed[u] && curdeg[u] > curdeg[v]) {
          --curdeg[u];
          if (curdeg[u] <= maxd) bucket[std::max(curdeg[u], d)].push_back(u);
        }
      }
    }
  }
  return core;
}

// Greedy clique seeded from the highest-core vertex (lower bound).
std::vector<int> greedy_clique(const Graph& g, const std::vector<int>& core) {
  int seed = 0;
  for (int v = 1; v < g.n; ++v)
    if (core[v] > core[seed]) seed = v;
  std::vector<int> clique{seed};
  std::vector<int> cand;
  for (int u : g.adj[seed]) cand.push_back(u);
  while (!cand.empty()) {
    int best = cand[0];
    for (int u : cand)
      if (core[u] > core[best]) best = u;
    clique.push_back(best);
    std::vector<int> next;
    for (int u : cand)
      if (u != best && g.connected(u, best)) next.push_back(u);
    cand.swap(next);
  }
  return clique;
}

// Greedy coloring of candidate set (ordered); returns color count per
// candidate as the classic Tomita-style bound.
void color_sort(const Graph& g, std::vector<int>& cand,
                std::vector<int>& colors) {
  const size_t m = cand.size();
  colors.resize(m);
  static thread_local std::vector<std::vector<int>> classes;
  size_t used = 0;
  for (auto& c : classes) c.clear();
  for (size_t i = 0; i < m; ++i) {
    int v = cand[i];
    size_t c = 0;
    for (; c < used; ++c) {
      bool ok = true;
      for (int u : classes[c]) {
        if (g.connected(v, u)) { ok = false; break; }
      }
      if (ok) break;
    }
    if (c == used) {
      if (classes.size() <= used) classes.emplace_back();
      classes[used].clear();
      ++used;
    }
    classes[c].push_back(v);
  }
  // re-emit candidates ordered by color, colors ascending
  size_t idx = 0;
  for (size_t c = 0; c < used; ++c) {
    for (int v : classes[c]) {
      cand[idx] = v;
      colors[idx] = static_cast<int>(c) + 1;
      ++idx;
    }
  }
}

struct Search {
  const Graph& g;
  std::atomic<int>& best_size;
  std::vector<int>& best_clique;
  std::mutex& best_mu;
  Clock::time_point deadline;
  std::atomic<bool>& timed_out;

  void expand(std::vector<int>& clique, std::vector<int>& cand) {
    if (Clock::now() > deadline) {
      timed_out.store(true, std::memory_order_relaxed);
      return;
    }
    std::vector<int> colors;
    color_sort(g, cand, colors);
    for (int i = static_cast<int>(cand.size()) - 1; i >= 0; --i) {
      if (timed_out.load(std::memory_order_relaxed)) return;
      int v = cand[i];
      int bound = static_cast<int>(clique.size()) + colors[i];
      if (bound <= best_size.load(std::memory_order_relaxed)) return;
      clique.push_back(v);
      std::vector<int> next;
      next.reserve(i);
      for (int j = 0; j < i; ++j)
        if (g.connected(cand[j], v)) next.push_back(cand[j]);
      if (next.empty()) {
        int sz = static_cast<int>(clique.size());
        int cur = best_size.load(std::memory_order_relaxed);
        if (sz > cur) {
          std::lock_guard<std::mutex> lk(best_mu);
          if (sz > best_size.load(std::memory_order_relaxed)) {
            best_clique = clique;
            best_size.store(sz, std::memory_order_relaxed);
          }
        }
      } else {
        expand(clique, next);
      }
      clique.pop_back();
    }
  }
};

} // namespace

extern "C" {

// adj_flat: row-major n*n {0,1}; out_members: caller buffer of size n.
// Returns clique size (>= 1 for nonempty graph), 0 for n == 0,
// -1 on timeout WITH the best-found clique still written to out_members.
int max_clique(const uint8_t* adj_flat, int n, double time_limit_s,
               int n_threads, int* out_members) {
  if (n <= 0) return 0;
  Graph g;
  g.n = n;
  g.adj.assign(n, {});
  g.mat.assign(n, std::vector<uint8_t>(n, 0));
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (i != j && adj_flat[static_cast<size_t>(i) * n + j]) {
        g.mat[i][j] = 1;
        if (j > i) {
          g.adj[i].push_back(j);
          g.adj[j].push_back(i);
        }
      }
    }
  }

  auto core = core_numbers(g);
  auto lb_clique = greedy_clique(g, core);

  std::atomic<int> best_size(static_cast<int>(lb_clique.size()));
  std::vector<int> best = lb_clique;
  std::mutex best_mu;
  std::atomic<bool> timed_out(false);
  auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(time_limit_s));

  // Root vertices ordered by core number descending; prune roots whose
  // core + 1 cannot beat the incumbent.
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return core[a] > core[b]; });

  std::atomic<size_t> next_root(0);
  int workers = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      Search s{g, best_size, best, best_mu, deadline, timed_out};
      for (;;) {
        size_t idx = next_root.fetch_add(1);
        if (idx >= order.size()) break;
        if (timed_out.load(std::memory_order_relaxed)) break;
        int v = order[idx];
        if (core[v] + 1 <= best_size.load(std::memory_order_relaxed))
          continue;
        std::vector<int> clique{v};
        std::vector<int> cand;
        for (int u : g.adj[v])
          if (core[u] + 1 > best_size.load(std::memory_order_relaxed))
            cand.push_back(u);
        s.expand(clique, cand);
      }
    });
  }
  for (auto& t : pool) t.join();

  std::lock_guard<std::mutex> lk(best_mu);
  for (size_t i = 0; i < best.size(); ++i) out_members[i] = best[i];
  int sz = static_cast<int>(best.size());
  return timed_out.load() ? -sz : sz;
}

// Core numbers for parity with pmc_graph::compute_cores (graph.cc:57-59).
void kcores(const uint8_t* adj_flat, int n, int* out_cores) {
  if (n <= 0) return;
  Graph g;
  g.n = n;
  g.adj.assign(n, {});
  g.mat.assign(n, std::vector<uint8_t>(n, 0));
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (i != j && adj_flat[static_cast<size_t>(i) * n + j]) {
        g.mat[i][j] = 1;
        if (j > i) {
          g.adj[i].push_back(j);
          g.adj[j].push_back(i);
        }
      }
  auto core = core_numbers(g);
  std::memcpy(out_cores, core.data(), sizeof(int) * n);
}

} // extern "C"
