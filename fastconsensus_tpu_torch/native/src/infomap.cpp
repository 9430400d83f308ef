// Two-level Infomap: map-equation minimization (Rosvall–Bergstrom 2008).
//
// First-party replacement for igraph's `community_infomap` (reference
// fast_consensus.py:268, :390).  Implements the core Infomap search — the
// map equation for undirected graphs optimized by Louvain-style local moves
// with aggregation passes — which is inherently sequential and therefore a
// host kernel, not a TPU one (SURVEY.md §2.23: "sequential — CPU fallback
// acceptable", §7 hard-part 4).
//
// Undirected map equation.  With node visit rates p_i = strength_i / 2m and
// module exit rates q_m = w_cross(m) / 2m:
//
//   L(M) = plogp(sum_m q_m) - 2 sum_m plogp(q_m)
//        + sum_m plogp(q_m + sum_{i in m} p_i) - sum_i plogp(p_i)
//
// (plogp(x) = x log2 x; the last term is partition-independent and dropped).
// Simplifications vs full Infomap: two-level codebook only (no hierarchy),
// no Markov-time / teleportation parameters — matching what the reference
// actually uses: `community_infomap()` with default arguments.

#include <atomic>
#include <cmath>
#include <cstring>
#include <thread>
#include <unordered_map>

#include "common.hpp"

namespace {

inline double plogp(double x) { return x > 0.0 ? x * std::log2(x) : 0.0; }

// Louvain-style local-move sweeps minimizing the map equation on graph g.
// labels: in/out module assignment.  Returns number of moves applied.
int64_t local_moves(const fc::Csr& g, std::vector<int32_t>& labels,
                    std::mt19937_64& rng, int max_sweeps) {
  const int32_t n = g.n;
  const double m2 = std::max(2.0 * g.total_w, 1e-12);

  std::vector<double> p(n, 0.0);   // module -> sum of visit rates
  std::vector<double> q(n, 0.0);   // module -> exit rate
  double sum_q = 0.0;
  for (int32_t u = 0; u < n; ++u) p[labels[u]] += g.strength[u] / m2;
  for (int32_t u = 0; u < n; ++u)
    for (int64_t k = g.off[u]; k < g.off[u + 1]; ++k)
      if (labels[g.nbr[k]] != labels[u]) q[labels[u]] += g.w[k] / m2;
  for (int32_t m = 0; m < n; ++m) sum_q += q[m];

  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::unordered_map<int32_t, double> wlink;  // module -> weight/2m from u
  int64_t total_moves = 0;

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    std::shuffle(order.begin(), order.end(), rng);
    int64_t moves = 0;
    for (int32_t u : order) {
      const int32_t a = labels[u];
      const double pu = g.strength[u] / m2;
      const double ku_ext = (g.strength[u] - 2.0 * g.selfw[u]) / m2;
      wlink.clear();
      for (int64_t k = g.off[u]; k < g.off[u + 1]; ++k)
        wlink[labels[g.nbr[k]]] += g.w[k] / m2;
      auto ita = wlink.find(a);
      const double w_ua = ita == wlink.end() ? 0.0 : ita->second;

      // module a's aggregates with u removed
      const double qa2 = q[a] - ku_ext + 2.0 * w_ua;
      const double pa2 = p[a] - pu;
      const double old_a = -2.0 * plogp(q[a]) + plogp(q[a] + p[a]);
      const double new_a = -2.0 * plogp(qa2) + plogp(qa2 + pa2);

      double best_delta = -1e-12;  // strict improvement required
      int32_t best = a;
      double best_qb2 = 0.0;
      for (const auto& kv : wlink) {
        const int32_t b = kv.first;
        if (b == a) continue;
        const double qb2 = q[b] + ku_ext - 2.0 * kv.second;
        const double pb2 = p[b] + pu;
        const double old_b = -2.0 * plogp(q[b]) + plogp(q[b] + p[b]);
        const double new_b = -2.0 * plogp(qb2) + plogp(qb2 + pb2);
        const double sum_q2 = sum_q + (qa2 - q[a]) + (qb2 - q[b]);
        const double delta = plogp(sum_q2) - plogp(sum_q) +
                             (new_a - old_a) + (new_b - old_b);
        if (delta < best_delta) {
          best_delta = delta;
          best = b;
          best_qb2 = qb2;
        }
      }

      if (best != a) {
        sum_q += (qa2 - q[a]) + (best_qb2 - q[best]);
        q[a] = qa2;
        p[a] = pa2;
        q[best] = best_qb2;
        p[best] += pu;
        labels[u] = best;
        ++moves;
      }
    }
    total_moves += moves;
    if (moves == 0) break;
  }
  return total_moves;
}

void infomap_single(const fc::Csr& g, uint64_t seed, int32_t* out) {
  const int32_t n = g.n;
  std::mt19937_64 rng(seed);
  std::vector<int32_t> flat(n);
  std::iota(flat.begin(), flat.end(), 0);
  local_moves(g, flat, rng, /*max_sweeps=*/32);

  // Aggregation passes: collapse modules to supernodes and move again,
  // until a pass makes no further moves (Louvain-style outer loop, the same
  // structure Infomap's core search uses).
  for (int level = 0; level < 8; ++level) {
    fc::compact_labels(flat);
    int32_t k = *std::max_element(flat.begin(), flat.end()) + 1;
    if (k <= 1) break;
    std::unordered_map<int64_t, double> agg;
    for (int32_t u = 0; u < n; ++u) {
      for (int64_t e = g.off[u]; e < g.off[u + 1]; ++e) {
        int32_t v = g.nbr[e];
        if (u > v) continue;  // CSR holds both orientations
        int32_t cu = flat[u], cv = flat[v];
        int64_t key = static_cast<int64_t>(std::min(cu, cv)) * k +
                      std::max(cu, cv);
        agg[key] += g.w[e];
      }
      if (g.selfw[u] > 0.0)
        agg[static_cast<int64_t>(flat[u]) * k + flat[u]] += g.selfw[u];
    }
    std::vector<int32_t> asrc, adst;
    std::vector<float> aw;
    asrc.reserve(agg.size());
    for (const auto& kv : agg) {
      asrc.push_back(static_cast<int32_t>(kv.first / k));
      adst.push_back(static_cast<int32_t>(kv.first % k));
      aw.push_back(static_cast<float>(kv.second));
    }
    fc::Csr cg = fc::Csr::build(asrc.data(), adst.data(), aw.data(),
                                static_cast<int64_t>(asrc.size()), k);
    std::vector<int32_t> clab(k);
    std::iota(clab.begin(), clab.end(), 0);
    if (local_moves(cg, clab, rng, /*max_sweeps=*/32) == 0) break;
    for (int32_t u = 0; u < n; ++u) flat[u] = clab[flat[u]];
  }
  fc::compact_labels(flat);
  std::memcpy(out, flat.data(), sizeof(int32_t) * n);
}

}  // namespace

extern "C" void fc_infomap(const int32_t* src, const int32_t* dst,
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
        infomap_single(g, seeds[p],
                       out_labels + static_cast<int64_t>(p) * n_nodes);
    });
  for (auto& th : pool) th.join();
}
