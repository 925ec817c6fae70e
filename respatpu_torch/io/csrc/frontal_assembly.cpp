// Assembly map of the multifrontal front pool (host).
//
// For every entry (i, c) of the filled pattern, in CSR order, the flat
// position in the pool of dense fronts where it is assembled: the front that
// owns it is that of the supernode holding min(i, c); inside the front a
// pivot column g sits at g - first pivot, an update row at wp + its place in
// the front's sorted row structure. What kernels/snlu_device.py's
// build_frontal_plan computes with array operations (two searches a
// filled entry over the concatenated row structures), as one pass: rows come
// in ascending order, so the current supernode's row structure is kept in a
// position table and an entry of its own front costs one lookup; an entry
// below the diagonal belongs to an earlier front and is found by bisection
// in that front's row structure.
//
// Returns 0, or -1 when an entry falls outside its front's row structure
// (the filled pattern is not structurally symmetric).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int frontal_asm_dst(int64_t n, int64_t nsn, const int64_t* indptr, const int32_t* indices,
                    const int64_t* snode_ptr, const int64_t* rs_ptr, const int64_t* rs,
                    const int64_t* off, const int64_t* wp, const int64_t* mp,
                    int64_t* asm_dst) {
  std::vector<int64_t> col2sn((size_t)n);
  for (int64_t s = 0; s < nsn; ++s)
    for (int64_t j = snode_ptr[s]; j < snode_ptr[s + 1]; ++j) col2sn[(size_t)j] = s;
  std::vector<int64_t> pos((size_t)n, -1);  // place in the current front's row structure
  int64_t cur = -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = col2sn[(size_t)i];
    if (s != cur) {
      if (cur >= 0)
        for (int64_t k = rs_ptr[cur]; k < rs_ptr[cur + 1]; ++k) pos[(size_t)rs[k]] = -1;
      for (int64_t k = rs_ptr[s]; k < rs_ptr[s + 1]; ++k) pos[(size_t)rs[k]] = k - rs_ptr[s];
      cur = s;
    }
    const int64_t li_own = i - snode_ptr[s];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t c = indices[p];
      const int64_t t = col2sn[(size_t)c];
      if (t >= s) {  // this row's front owns the entry
        int64_t lj;
        if (c < snode_ptr[s + 1]) {
          lj = c - snode_ptr[s];
        } else {
          if (pos[(size_t)c] < 0) return -1;
          lj = wp[s] + pos[(size_t)c];
        }
        asm_dst[p] = off[s] + li_own * mp[s] + lj;
      } else {  // the column's (earlier) front owns it; row i is one of its update rows
        const int64_t* b = rs + rs_ptr[t];
        const int64_t* e = rs + rs_ptr[t + 1];
        const int64_t* it = std::lower_bound(b, e, i);
        if (it == e || *it != i) return -1;
        asm_dst[p] = off[t] + (wp[t] + (it - b)) * mp[t] + (c - snode_ptr[t]);
      }
    }
  }
  return 0;
}

}  // extern "C"
