// Reverse Cuthill-McKee ordering of a square sparse pattern (host).
//
// The port's own copy of the routine the JAX package keeps in its host
// library, with the symmetrization in front of it: rcm_order_csr takes the
// matrix's CSR pattern as it is, builds the pattern of A + A^T without the
// diagonal (each row's neighbours ascending, as analysis.py's
// symmetrized_adjacency does with numpy sorts, which take seconds at a
// million entries), and orders that. A vertex's degree is its number of
// neighbours. Seeds are the unvisited vertex of least degree (lowest index on
// a tie); neighbours are visited by (degree, index). The Python
// breadth-first search in analysis.py follows the same rules and gives the
// same order.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

int rcm_order(int64_t n, const int64_t* indptr, const int32_t* indices, int32_t* order_out) {
  std::vector<int32_t> deg((size_t)n);
  for (int64_t i = 0; i < n; ++i) deg[(size_t)i] = (int32_t)(indptr[i + 1] - indptr[i]);
  std::vector<char> visited((size_t)n, 0);
  // vertices by (degree, index): the next seed is the first unvisited one
  std::vector<int32_t> by_deg((size_t)n);
  for (int64_t i = 0; i < n; ++i) by_deg[(size_t)i] = (int32_t)i;
  std::stable_sort(by_deg.begin(), by_deg.end(),
                   [&](int32_t a, int32_t b) { return deg[(size_t)a] < deg[(size_t)b]; });
  size_t next_seed = 0;
  std::vector<int32_t> q;
  q.reserve((size_t)n);
  int64_t pos = 0;
  std::vector<int32_t> nbs;
  while (pos < n) {
    while (next_seed < (size_t)n && visited[(size_t)by_deg[next_seed]]) ++next_seed;
    if (next_seed >= (size_t)n) break;
    int32_t seed = by_deg[next_seed];
    size_t qh = q.size();
    q.push_back(seed);
    visited[(size_t)seed] = 1;
    while (qh < q.size()) {
      int32_t v = q[qh++];
      order_out[pos++] = v;
      nbs.clear();
      for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
        int32_t w = indices[p];
        if (w != v && !visited[(size_t)w]) {
          visited[(size_t)w] = 1;
          nbs.push_back(w);
        }
      }
      std::sort(nbs.begin(), nbs.end(), [&](int32_t a, int32_t b) {
        return deg[(size_t)a] < deg[(size_t)b] || (deg[(size_t)a] == deg[(size_t)b] && a < b);
      });
      for (int32_t w : nbs) q.push_back(w);
    }
  }
  for (int64_t i = 0; i < n / 2; ++i) std::swap(order_out[i], order_out[n - 1 - i]);
  return 0;
}

}  // namespace

// `indptr` (int64[n + 1]) and `indices` (int32, in [0, n)) are the CSR
// pattern of an n x n matrix; `order_out` (int32[n]) receives the ordering.
extern "C" int rcm_order_csr(int64_t n, const int64_t* indptr, const int32_t* indices,
                             int32_t* order_out) {
  // A + A^T without the diagonal: count, fill, then sort and dedupe each row
  std::vector<int64_t> ptr((size_t)n + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j < 0 || j >= n) return 1;
      if (j != i) {
        ++ptr[(size_t)i + 1];
        ++ptr[(size_t)j + 1];
      }
    }
  for (int64_t i = 0; i < n; ++i) ptr[(size_t)i + 1] += ptr[(size_t)i];
  std::vector<int32_t> adj((size_t)ptr[(size_t)n]);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j != i) {
        adj[(size_t)fill[(size_t)i]++] = j;
        adj[(size_t)fill[(size_t)j]++] = (int32_t)i;
      }
    }
  std::vector<int64_t> sym_ptr((size_t)n + 1, 0);
  int64_t out = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t* first = adj.data() + ptr[(size_t)i];
    int32_t* last = adj.data() + ptr[(size_t)i + 1];
    std::sort(first, last);
    last = std::unique(first, last);
    for (int32_t* q = first; q != last; ++q) adj[(size_t)out++] = *q;  // out <= q's index
    sym_ptr[(size_t)i + 1] = out;
  }
  return rcm_order(n, sym_ptr.data(), adj.data(), order_out);
}
