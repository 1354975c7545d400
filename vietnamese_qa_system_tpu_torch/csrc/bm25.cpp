// Native BM25 posting-list scorer (hybrid retrieval's host-side hot loop).
//
// A copy of vietnamese_qa_system_tpu/native/bm25.cpp.  The dense half of
// hybrid retrieval runs on the card (the top-k kernels); the lexical half
// is an inverted index whose scoring loop is pointer-chasing accumulation,
// host work by design.  Built by g++ (not nvcc) at first use into
// csrc/build/ (engine/lexical.py).
//
// Plain C ABI for ctypes.  All math in double to match the Python scorer
// in engine/lexical.py term for term; only the accumulation order differs
// (~1e-15 relative).
//
// Layout: query term t owns postings [term_off[t], term_off[t+1]) of the
// gids/tf/dlen arrays (slices concatenated by the Python caller).

#include <cstddef>
#include <cstdint>
#include <unordered_map>

extern "C" {

// Returns the number of distinct candidate docs written to out_*.
// out_gids/out_scores must hold at least term_off[n_terms] entries
// (every posting distinct is the worst case).
int64_t bm25_score(const int64_t* term_off, const double* idf,
                   int32_t n_terms, const int64_t* gids, const double* tf,
                   const double* dlen, double k1, double b, double avg_len,
                   int64_t* out_gids, double* out_scores) {
  std::unordered_map<int64_t, double> acc;
  const int64_t total = term_off[n_terms];
  acc.reserve(total > 16 ? (std::size_t)total : 16);
  const double k1p1 = k1 + 1.0;
  for (int32_t t = 0; t < n_terms; ++t) {
    const double w = idf[t];
    for (int64_t p = term_off[t]; p < term_off[t + 1]; ++p) {
      const double tfv = tf[p];
      const double denom = tfv + k1 * (1.0 - b + b * dlen[p] / avg_len);
      acc[gids[p]] += w * tfv * k1p1 / denom;
    }
  }
  int64_t n = 0;
  for (const auto& kv : acc) {
    out_gids[n] = kv.first;
    out_scores[n] = kv.second;
    ++n;
  }
  return n;
}

}  // extern "C"
