// Fast edgelist ingest (the framework's native data loader).
//
// The reference parses input with `nx.read_edgelist` — a pure-Python
// line-by-line parse into dict-of-dicts (reference fast_consensus.py:434),
// which dominates startup on large graphs.  This is a single-pass mmap-free
// buffered C++ parser for the same format: `u v [w]` per line, `#` comments,
// blank lines.  It also fixes the reference's weighted-format crash
// (SURVEY.md §2.22.6): a third column parses as a float weight.
//
// Two-call ABI (count, then fill) keeps memory ownership in Python.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
  std::vector<int64_t> u, v;
  std::vector<double> w;
  bool saw_weight = false;
  bool ok = false;
};

Parsed parse(const char* path) {
  Parsed out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = p + got;
  while (p < end) {
    // one line
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    const char* q = p;
    auto skip_ws = [&]() {
      while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    };
    skip_ws();
    if (q < eol && *q != '#') {
      char* next = nullptr;
      long long a = std::strtoll(q, &next, 10);
      if (next == q || next > eol) { out.ok = false; return out; }
      q = next;
      skip_ws();
      long long b = std::strtoll(q, &next, 10);
      if (next == q || next > eol) { out.ok = false; return out; }
      q = next;
      skip_ws();
      double wv = 1.0;
      if (q < eol && *q != '#' && *q != '\0') {
        wv = std::strtod(q, &next);
        // strict: the token must parse and be followed only by whitespace
        // or a comment (malformed weights must error, not default to 1.0,
        // matching the pure-Python parser's behavior)
        if (next == q || next > eol) { out.ok = false; return out; }
        q = next;
        skip_ws();
        if (q < eol && *q != '#') { out.ok = false; return out; }
        out.saw_weight = true;
      }
      out.u.push_back(a);
      out.v.push_back(b);
      out.w.push_back(wv);
    }
    p = eol + 1;
  }
  out.ok = true;
  return out;
}

Parsed g_last;  // single-slot cache between count and fill calls

}  // namespace

extern "C" {

// Returns edge count, or -1 on I/O/parse error.  saw_weight set to 0/1.
int64_t fc_parse_edgelist_count(const char* path, int32_t* saw_weight) {
  g_last = parse(path);
  if (!g_last.ok) return -1;
  *saw_weight = g_last.saw_weight ? 1 : 0;
  return static_cast<int64_t>(g_last.u.size());
}

// Fills caller-allocated arrays of length n (from the preceding count call).
void fc_parse_edgelist_fill(int64_t* u, int64_t* v, double* w, int64_t n) {
  if (n > static_cast<int64_t>(g_last.u.size()))
    n = static_cast<int64_t>(g_last.u.size());
  std::memcpy(u, g_last.u.data(), sizeof(int64_t) * n);
  std::memcpy(v, g_last.v.data(), sizeof(int64_t) * n);
  std::memcpy(w, g_last.w.data(), sizeof(double) * n);
  g_last = Parsed{};
}

}  // extern "C"
