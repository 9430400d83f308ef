// The host detectors' step inside a captured round block: the port's
// counterpart of the reference's jax.pure_callback into CNM or Infomap
// (fastconsensus_tpu/models/cnm.py:51-60, vmap_method="sequential").
//
// On the card a fused round block (ops/capture.py, engine.RoundsBlock and
// engine.BatchBlock) is one CUDA graph.  A host detector's round there is
// copies of the slab and the member keys into pinned host buffers, a host
// node that calls fc_host_detect, and a copy of the labels back.  The node
// runs on the CUDA driver's callback thread, so this function takes no
// Python lock and calls no CUDA API: it reads and writes only the buffers
// its argument names.
//
// For each job j in order whose runs[j] is set it does what one eager
// round's host call does (models/cnm.py make_host_detector): it compacts
// the alive edge slots in slot order, forms each member's 64-bit seed as
// (w[0] << 32) | w[key_words - 1] from its key's uint32 words, and runs
// fc_cnm or fc_infomap into job j's int32 labels.  A job whose flag is
// clear (a stopped block, a frozen job) keeps its labels untouched.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" void fc_cnm(const int32_t* src, const int32_t* dst,
                       const float* w, int64_t n_edges, int32_t n_nodes,
                       const uint64_t* seeds, int32_t n_p,
                       int32_t* out_labels);
extern "C" void fc_infomap(const int32_t* src, const int32_t* dst,
                           const float* w, int64_t n_edges, int32_t n_nodes,
                           const uint64_t* seeds, int32_t n_p,
                           int32_t* out_labels);

namespace {

// The argument of fc_host_detect (native/__init__.py HostDetectArgs mirrors
// it field by field).
struct HostDetectArgs {
  int32_t detector;      // 0: CNM, 1: Infomap
  int32_t n_jobs;
  int32_t n_nodes;
  int32_t n_p;
  int64_t capacity;      // edge slots a job
  int64_t key_words;     // uint32 words a key
  const int64_t* src;    // [n_jobs, capacity]
  const int64_t* dst;    // [n_jobs, capacity]
  const float* weight;   // [n_jobs, capacity]
  const uint8_t* alive;  // [n_jobs, capacity], bool
  const int64_t* keys;   // [n_jobs * n_p, key_words], uint32 words
  const uint8_t* runs;   // [n_jobs], bool
  int32_t* labels;       // [n_jobs, n_p, n_nodes]
  int64_t calls;         // executions with at least one job to detect
  int64_t detections;    // jobs detected
};

}  // namespace

extern "C" int64_t fc_host_detect_args_size() {
  return static_cast<int64_t>(sizeof(HostDetectArgs));
}

extern "C" void fc_host_detect(void* arg) {
  auto* a = static_cast<HostDetectArgs*>(arg);
  std::vector<int32_t> src, dst;
  std::vector<float> w;
  std::vector<uint64_t> seeds(static_cast<size_t>(a->n_p));
  bool any = false;
  for (int32_t j = 0; j < a->n_jobs; ++j) {
    if (!a->runs[j]) continue;
    any = true;
    const int64_t off = static_cast<int64_t>(j) * a->capacity;
    src.clear();
    dst.clear();
    w.clear();
    for (int64_t e = 0; e < a->capacity; ++e) {
      if (!a->alive[off + e]) continue;
      src.push_back(static_cast<int32_t>(a->src[off + e]));
      dst.push_back(static_cast<int32_t>(a->dst[off + e]));
      w.push_back(a->weight[off + e]);
    }
    for (int32_t p = 0; p < a->n_p; ++p) {
      const int64_t* k =
          a->keys + (static_cast<int64_t>(j) * a->n_p + p) * a->key_words;
      seeds[p] = (static_cast<uint64_t>(static_cast<uint32_t>(k[0])) << 32) |
                 static_cast<uint32_t>(k[a->key_words - 1]);
    }
    int32_t* out = a->labels +
                   static_cast<int64_t>(j) * a->n_p * a->n_nodes;
    const int64_t n_edges = static_cast<int64_t>(src.size());
    if (a->detector == 0)
      fc_cnm(src.data(), dst.data(), w.data(), n_edges, a->n_nodes,
             seeds.data(), a->n_p, out);
    else
      fc_infomap(src.data(), dst.data(), w.data(), n_edges, a->n_nodes,
                 seeds.data(), a->n_p, out);
    ++a->detections;
  }
  if (any) ++a->calls;
}
