// Shared graph scaffolding for the native (host-side) detection kernels.
//
// The reference reaches its sequential community algorithms through igraph's
// C core (reference fast_consensus.py:41-52, :268, :270, :335); these are the
// first-party C++ equivalents.  The TPU compute path (JAX/XLA) never touches
// this code — it serves the two inherently sequential algorithms (CNM
// fast-greedy agglomeration, Infomap map-equation search; SURVEY.md §7 "hard
// parts" 4) plus fast file ingest.
#pragma once

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>

namespace fc {

// Immutable undirected weighted graph in CSR form (both edge orientations).
struct Csr {
  int32_t n = 0;
  std::vector<int64_t> off;   // size n+1
  std::vector<int32_t> nbr;   // size 2E
  std::vector<double> w;      // size 2E
  std::vector<double> strength;  // weighted degree incl. 2*self-loops
  std::vector<double> selfw;     // self-loop weight per node
  double total_w = 0.0;          // sum of edge weights (each edge once)

  static Csr build(const int32_t* src, const int32_t* dst, const float* wt,
                   int64_t n_edges, int32_t n_nodes) {
    Csr g;
    g.n = n_nodes;
    g.strength.assign(n_nodes, 0.0);
    g.selfw.assign(n_nodes, 0.0);
    std::vector<int64_t> deg(n_nodes, 0);
    for (int64_t e = 0; e < n_edges; ++e) {
      double w = wt ? static_cast<double>(wt[e]) : 1.0;
      g.total_w += w;
      if (src[e] == dst[e]) {
        g.selfw[src[e]] += w;
        g.strength[src[e]] += 2.0 * w;
        continue;
      }
      ++deg[src[e]];
      ++deg[dst[e]];
      g.strength[src[e]] += w;
      g.strength[dst[e]] += w;
    }
    g.off.assign(n_nodes + 1, 0);
    for (int32_t i = 0; i < n_nodes; ++i) g.off[i + 1] = g.off[i] + deg[i];
    g.nbr.resize(g.off[n_nodes]);
    g.w.resize(g.off[n_nodes]);
    std::vector<int64_t> cur(g.off.begin(), g.off.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      if (src[e] == dst[e]) continue;
      double w = wt ? static_cast<double>(wt[e]) : 1.0;
      g.nbr[cur[src[e]]] = dst[e];
      g.w[cur[src[e]]++] = w;
      g.nbr[cur[dst[e]]] = src[e];
      g.w[cur[dst[e]]++] = w;
    }
    return g;
  }
};

// Compact labels to 0..k-1 by first occurrence.
inline void compact_labels(std::vector<int32_t>& lab) {
  std::vector<int32_t> remap(lab.size(), -1);
  int32_t next = 0;
  for (auto& l : lab) {
    if (remap[l] < 0) remap[l] = next++;
    l = remap[l];
  }
}

}  // namespace fc
