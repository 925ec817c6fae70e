// Symmetric-pattern symbolic factorization via the elimination tree (host).
//
// The port's own copy of the routine the JAX package keeps in its host
// library. For a structurally symmetric pattern (the multifrontal analysis
// symmetrizes first):
//   1. elimination tree by Liu's algorithm with path compression,
//   2. column structures bottom-up: struct(j) = {i in A[:,j], i > j}
//      union {e in struct(c), e > j : c child of j}  (children come
//      before parents, so one ascending pass suffices),
//   3. filled CSR assembled from the column structures (lower part by a
//      counting transpose pass, upper part = struct(i) by symmetry).
// Work is O(fill log fill). PARDISO phase-11 slot (test_pardiso.c:185-187).
//
// Two-phase interface: symbolic_fill_sym_compute keeps the result and
// returns its size, symbolic_fill_fetch copies it into the caller's arrays
// and frees it. The Python caller holds a lock across the two.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FillResult {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
};

FillResult* g_fill_result = nullptr;

}  // namespace

extern "C" {

int64_t symbolic_fill_sym_compute(int64_t n, const int64_t* indptr,
                                  const int32_t* indices) {
  delete g_fill_result;
  g_fill_result = new FillResult();
  auto& out = *g_fill_result;

  // 1. etree (parent[j] = min{i > j : L[i,j] != 0}) via path compression
  std::vector<int32_t> parent((size_t)n, -1), ancestor((size_t)n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t k = indices[p];
      if (k >= (int32_t)i) continue;
      int32_t j = k;
      while (ancestor[j] != -1 && ancestor[j] != (int32_t)i) {
        int32_t next = ancestor[j];
        ancestor[j] = (int32_t)i;
        j = next;
      }
      if (ancestor[j] == -1) {
        ancestor[j] = (int32_t)i;
        parent[j] = (int32_t)i;
      }
    }
  }

  // children lists (CSR-style; parent[j] > j so ascending j is bottom-up)
  std::vector<int64_t> cptr((size_t)n + 1, 0);
  for (int64_t j = 0; j < n; ++j)
    if (parent[j] >= 0) cptr[(size_t)parent[j] + 1]++;
  for (int64_t j = 0; j < n; ++j) cptr[(size_t)j + 1] += cptr[(size_t)j];
  std::vector<int32_t> childs((size_t)cptr[(size_t)n]);
  {
    std::vector<int64_t> w(cptr.begin(), cptr.end() - 1);
    for (int64_t j = 0; j < n; ++j)
      if (parent[j] >= 0) childs[(size_t)w[(size_t)parent[j]]++] = (int32_t)j;
  }

  // 2. bottom-up column structures (strict lower part of each column)
  std::vector<std::vector<int32_t>> st((size_t)n);
  std::vector<int32_t> buf;
  for (int64_t j = 0; j < n; ++j) {
    buf.clear();
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p)
      if (indices[p] > (int32_t)j) buf.push_back(indices[p]);
    for (int64_t cp = cptr[(size_t)j]; cp < cptr[(size_t)j + 1]; ++cp) {
      const std::vector<int32_t>& sc = st[(size_t)childs[(size_t)cp]];
      // child structures are sorted; skip entries <= j (the parent edge)
      auto it = std::upper_bound(sc.begin(), sc.end(), (int32_t)j);
      buf.insert(buf.end(), it, sc.end());
    }
    std::sort(buf.begin(), buf.end());
    buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
    st[(size_t)j] = buf;
  }

  // 3. assemble the filled CSR (row-major, sorted columns):
  //    row i = {j < i : i in struct(j)}  +  {i}  +  struct(i)
  out.indptr.assign((size_t)n + 1, 0);
  for (int64_t j = 0; j < n; ++j) {
    out.indptr[(size_t)j + 1] += (int64_t)st[(size_t)j].size() + 1;  // diag+upper of row j
    for (int32_t i : st[(size_t)j]) out.indptr[(size_t)i + 1]++;      // lower slots of row i
  }
  for (int64_t i = 0; i < n; ++i)
    out.indptr[(size_t)i + 1] += out.indptr[(size_t)i];
  out.indices.assign((size_t)out.indptr[(size_t)n], 0);
  std::vector<int64_t> w(out.indptr.begin(), out.indptr.end() - 1);
  // ascending j keeps each row's lower part sorted automatically
  for (int64_t j = 0; j < n; ++j)
    for (int32_t i : st[(size_t)j])
      out.indices[(size_t)w[(size_t)i]++] = (int32_t)j;
  for (int64_t i = 0; i < n; ++i) {
    out.indices[(size_t)w[(size_t)i]++] = (int32_t)i;
    for (int32_t u : st[(size_t)i]) out.indices[(size_t)w[(size_t)i]++] = u;
  }
  return out.indptr[(size_t)n];
}

int symbolic_fill_fetch(int64_t n, int64_t* out_indptr, int32_t* out_indices) {
  if (!g_fill_result) return -1;
  memcpy(out_indptr, g_fill_result->indptr.data(), sizeof(int64_t) * ((size_t)n + 1));
  memcpy(out_indices, g_fill_result->indices.data(),
         sizeof(int32_t) * g_fill_result->indices.size());
  delete g_fill_result;
  g_fill_result = nullptr;
  return 0;
}

}  // extern "C"
