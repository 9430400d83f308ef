// CNM fast-greedy modularity agglomeration (Clauset–Newman–Moore 2004).
//
// First-party replacement for igraph's `community_fastgreedy` C routine that
// the reference calls per randomized relabeling (reference
// fast_consensus.py:319-335, :393-411).  The algorithm is inherently
// sequential (one best-pair merge at a time), which is why it lives here on
// the host rather than as a TPU kernel (SURVEY.md §2.23, §7).
//
// Agglomerates all the way to one community while recording the merge
// sequence, then replays the merges up to the modularity peak — the same
// "full dendrogram, cut at max Q" contract as igraph's
// `community_fastgreedy(...).as_clustering()`.
//
// Randomization: the reference randomizes the deterministic algorithm by
// shuffling node ids before each run (fc:326-332).  Here each seed applies a
// random node permutation that perturbs heap tie-breaking identically.
//
// Conventions: E_ij = (sum of A_uv over ordered pairs u in i, v in j) / 2m,
// a_i = strength_i / 2m, Q = sum_i (E_ii - a_i^2), merge gain
// dQ(i,j) = 2 (E_ij - a_i a_j).

#include <atomic>
#include <cstring>
#include <functional>
#include <queue>
#include <thread>
#include <unordered_map>

#include "common.hpp"

namespace {

struct HeapItem {
  double dq;
  int32_t a, b;     // community ids
  uint64_t stamp;   // lazy invalidation: per-community version sum
  bool operator<(const HeapItem& o) const { return dq < o.dq; }
};

// One full CNM run on a permuted view of the graph.
void cnm_single(const fc::Csr& g, uint64_t seed, int32_t* out) {
  const int32_t n = g.n;
  const double m2 = std::max(2.0 * g.total_w, 1e-12);

  std::mt19937_64 rng(seed);
  std::vector<int32_t> perm(n);
  std::iota(perm.begin(), perm.end(), 0);
  std::shuffle(perm.begin(), perm.end(), rng);  // orig -> permuted id

  std::vector<std::unordered_map<int32_t, double>> e(n);
  std::vector<double> a(n, 0.0);
  for (int32_t u = 0; u < n; ++u) {
    int32_t pu = perm[u];
    a[pu] = g.strength[u] / m2;
    if (g.selfw[u] > 0.0) e[pu][pu] += 2.0 * g.selfw[u] / m2;
    for (int64_t k = g.off[u]; k < g.off[u + 1]; ++k) {
      int32_t pv = perm[g.nbr[k]];
      e[pu][pv] += g.w[k] / m2;
    }
  }

  std::vector<uint64_t> version(n, 0);
  std::vector<bool> alive(n, true);
  std::priority_queue<HeapItem> heap;
  auto push_pair = [&](int32_t i, int32_t j) {
    if (i == j) return;
    auto it = e[i].find(j);
    if (it == e[i].end()) return;
    heap.push({2.0 * (it->second - a[i] * a[j]), i, j,
               version[i] + version[j]});
  };
  for (int32_t i = 0; i < n; ++i)
    for (const auto& kv : e[i])
      if (i < kv.first) push_pair(i, kv.first);

  std::vector<std::pair<int32_t, int32_t>> merges;
  merges.reserve(n > 0 ? n - 1 : 0);
  double q = 0.0;
  for (int32_t i = 0; i < n; ++i) {
    auto it = e[i].find(i);
    double eii = it == e[i].end() ? 0.0 : it->second;
    q += eii - a[i] * a[i];
  }
  double best_q = q;
  int64_t best_step = 0;

  while (!heap.empty()) {
    HeapItem top = heap.top();
    heap.pop();
    int32_t i = top.a, j = top.b;
    if (!alive[i] || !alive[j] || top.stamp != version[i] + version[j])
      continue;  // stale entry
    if (e[i].size() < e[j].size()) std::swap(i, j);  // i absorbs j
    alive[j] = false;
    ++version[i];
    ++version[j];
    double eij = 0.0, ejj = 0.0;
    for (const auto& kv : e[j]) {
      int32_t k = kv.first;
      if (k == j) {
        ejj = kv.second;
      } else if (k == i) {
        eij = kv.second;
      } else {
        e[i][k] += kv.second;
        auto& mk = e[k];
        mk.erase(j);
        mk[i] += kv.second;
      }
    }
    e[i][i] += ejj + 2.0 * eij;  // ordered-pair convention
    e[i].erase(j);
    e[j].clear();
    a[i] += a[j];
    q += top.dq;
    merges.emplace_back(i, j);
    if (q > best_q) {
      best_q = q;
      best_step = static_cast<int64_t>(merges.size());
    }
    for (const auto& kv : e[i])
      if (kv.first != i && alive[kv.first]) push_pair(i, kv.first);
  }

  // Replay merges up to the modularity peak with union-find.
  std::vector<int32_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) x = parent[x] = parent[parent[x]];
    return x;
  };
  for (int64_t s = 0; s < best_step; ++s)
    parent[find(merges[s].second)] = find(merges[s].first);

  std::vector<int32_t> lab(n);
  for (int32_t u = 0; u < n; ++u) lab[u] = find(perm[u]);
  fc::compact_labels(lab);
  std::memcpy(out, lab.data(), sizeof(int32_t) * n);
}

}  // namespace

extern "C" void fc_cnm(const int32_t* src, const int32_t* dst,
                       const float* w, int64_t n_edges, int32_t n_nodes,
                       const uint64_t* seeds, int32_t n_p,
                       int32_t* out_labels /* n_p * n_nodes */) {
  fc::Csr g = fc::Csr::build(src, dst, w, n_edges, n_nodes);
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = std::max(1, std::min<int>(n_p, hw ? hw : 1));
  std::vector<std::thread> pool;
  std::atomic<int32_t> next{0};
  for (int t = 0; t < n_threads; ++t)
    pool.emplace_back([&]() {
      for (int32_t p; (p = next.fetch_add(1)) < n_p;)
        cnm_single(g, seeds[p],
                   out_labels + static_cast<int64_t>(p) * n_nodes);
    });
  for (auto& th : pool) th.join();
}
