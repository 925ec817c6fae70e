// Host schedules of the ILU(0) path and the scheduled LU: the level
// (wavefront) of every row of a triangular solve, the Chow-Patel pair lists of
// every stored entry, and the level of every entry of an exact elimination.
//
// level_schedule and cp_schedule_count are the routines of respatpu's host
// library as they are; cp_schedule_fill writes the pair lists ragged (entry p
// owns pairs ptr[p] .. ptr[p+1] - 1) instead of padded to the longest list,
// since one hub row of a circuit would otherwise pad every entry;
// entry_levels reads those ragged lists.
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// level[i] = 1 + max(level[j]) over dependencies j of row i.
// lower=1: deps are cols < i, processed 0..n-1; lower=0: cols > i, n-1..0.
int level_schedule(int64_t n, const int64_t* indptr, const int32_t* indices,
                   int32_t lower, int32_t* level) {
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int32_t lv = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        int32_t j = indices[p];
        if (j < i && level[j] >= lv) lv = level[j] + 1;
      }
      level[i] = lv;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int32_t lv = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        int32_t j = indices[p];
        if (j > i && level[j] >= lv) lv = level[j] + 1;
      }
      level[i] = lv;
    }
  }
  return 0;
}

// Pass 1: count intersection sizes per nnz -> tcount[nnz]; returns max count.
// Pass 2 (cp_schedule_fill): fill the ragged pair lists at the offsets ptr.
// Requires CSC arrays (col_ptr[n+1], col_rows = row index per entry sorted by
// (col,row), col_pos = nnz position of that entry).
int64_t cp_schedule_count(int64_t n, const int64_t* indptr, const int32_t* indices,
                          const int64_t* col_ptr, const int32_t* col_rows,
                          int32_t* tcount, int32_t nthreads) {
  std::vector<int64_t> rowof(indptr[n]);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) rowof[(size_t)p] = i;
  if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  std::vector<int64_t> maxes(nthreads, 0);
  int64_t nnz = indptr[n];
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([&, t]() {
      int64_t mx = 0;
      for (int64_t p = t; p < nnz; p += nthreads) {
        int64_t i = rowof[(size_t)p];
        int32_t j = indices[p];
        int64_t kmax = i < j ? i : j;
        // merge-walk row i cols (<kmax) against col j rows (<kmax)
        int64_t ra = indptr[i], rb = indptr[i + 1];
        int64_t ca = col_ptr[j], cb = col_ptr[j + 1];
        int64_t cnt = 0;
        while (ra < rb && ca < cb) {
          int32_t a = indices[ra];
          int32_t b = col_rows[ca];
          if (a >= kmax || b >= kmax) break;
          if (a == b) { ++cnt; ++ra; ++ca; }
          else if (a < b) ++ra;
          else ++ca;
        }
        tcount[p] = (int32_t)cnt;
        if (cnt > mx) mx = cnt;
      }
      maxes[t] = mx;
    });
  for (auto& th : threads) th.join();
  int64_t mx = 0;
  for (auto m : maxes) if (m > mx) mx = m;
  return mx;
}

int cp_schedule_fill(int64_t n, const int64_t* indptr, const int32_t* indices,
                     const int64_t* col_ptr, const int32_t* col_rows,
                     const int64_t* col_pos, const int64_t* ptr,
                     int64_t* pairs_a, int64_t* pairs_b, int32_t nthreads) {
  std::vector<int64_t> rowof(indptr[n]);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) rowof[(size_t)p] = i;
  if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  int64_t nnz = indptr[n];
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([&, t]() {
      for (int64_t p = t; p < nnz; p += nthreads) {
        int64_t i = rowof[(size_t)p];
        int32_t j = indices[p];
        int64_t kmax = i < j ? i : j;
        int64_t ra = indptr[i], rb = indptr[i + 1];
        int64_t ca = col_ptr[j], cb = col_ptr[j + 1];
        int64_t w = ptr[p];
        while (ra < rb && ca < cb) {
          int32_t a = indices[ra];
          int32_t b = col_rows[ca];
          if (a >= kmax || b >= kmax) break;
          if (a == b) {
            pairs_a[w] = ra;
            pairs_b[w] = col_pos[ca];
            ++w; ++ra; ++ca;
          } else if (a < b) ++ra;
          else ++ca;
        }
      }
    });
  for (auto& th : threads) th.join();
  return 0;
}

// level[p] = 1 + the largest level among entry p's pair entries (l_ik, u_kj)
// and, for an entry below the diagonal, its column's diagonal u_jj; 0 for an
// entry with neither. Every one of them precedes p in CSR order (row i's own
// earlier columns, or an earlier row), so one forward pass suffices.
int entry_levels(int64_t nnz, const int64_t* ptr, const int64_t* pairs_a,
                 const int64_t* pairs_b, const int64_t* diag_pos_col,
                 const int8_t* is_lower, int32_t* level) {
  for (int64_t p = 0; p < nnz; ++p) {
    int32_t lv = 0;
    for (int64_t t = ptr[p]; t < ptr[p + 1]; ++t) {
      int32_t la = level[pairs_a[t]];
      int32_t lb = level[pairs_b[t]];
      int32_t m = la > lb ? la : lb;
      if (m >= lv) lv = m + 1;
    }
    if (is_lower[p] && diag_pos_col[p] >= 0) {
      int32_t ld = level[diag_pos_col[p]];
      if (ld >= lv) lv = ld + 1;
    }
    level[p] = lv;
  }
  return 0;
}

}  // extern "C"
