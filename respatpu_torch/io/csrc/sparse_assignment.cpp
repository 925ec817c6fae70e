// Sparse assignment: the MC64 weighted-matching slot (host).
//
// The port's own copy of the routine the JAX package keeps in its host
// library. Minimum-cost perfect bipartite matching on a sparse cost matrix
// by shortest augmenting paths with dual potentials (the Jonker-Volgenant
// scheme for sparse inputs: the algorithm underlying MC64's max-product
// option once costs are log-transformed, which the Python caller does).
// Returns 0 and match_out[i] = column matched to row i, or -1 when no
// perfect matching exists (structurally singular).

#include <algorithm>
#include <cstdint>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

int sparse_assignment(int64_t n, const int64_t* indptr, const int32_t* indices,
                      const double* cost, int32_t* match_out) {
  const double INF = 1e300;
  std::vector<int32_t> match_row((size_t)n, -1), match_col((size_t)n, -1);
  std::vector<double> u((size_t)n, 0.0), v((size_t)n, 0.0);
  // row potentials = row minima; greedy zero-reduced-cost pass
  for (int64_t i = 0; i < n; ++i) {
    if (indptr[i] == indptr[i + 1]) return -1;  // empty row
    double m = INF;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      m = std::min(m, cost[p]);
    u[(size_t)i] = m;
  }
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t j = indices[p];
      if (match_col[(size_t)j] == -1 &&
          cost[p] - u[(size_t)i] - v[(size_t)j] <= 1e-12) {
        match_row[(size_t)i] = j;
        match_col[(size_t)j] = (int32_t)i;
        break;
      }
    }
  }
  // augment each remaining free row (Dijkstra over reduced costs)
  std::vector<double> dist((size_t)n, INF);
  std::vector<int32_t> pred((size_t)n, -1);
  std::vector<char> done((size_t)n, 0);
  std::vector<int32_t> touched;
  typedef std::pair<double, int32_t> QE;
  for (int64_t r0 = 0; r0 < n; ++r0) {
    if (match_row[(size_t)r0] != -1) continue;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
    touched.clear();
    for (int64_t p = indptr[r0]; p < indptr[r0 + 1]; ++p) {
      int32_t j = indices[p];
      double d = cost[p] - u[(size_t)r0] - v[(size_t)j];
      if (d < dist[(size_t)j]) {
        if (dist[(size_t)j] == INF) touched.push_back(j);  // first touch only
        dist[(size_t)j] = d;
        pred[(size_t)j] = (int32_t)r0;
        q.push({d, j});
      }
    }
    int32_t jf = -1;
    double dmin = 0.0;
    while (!q.empty()) {
      QE e = q.top();
      q.pop();
      int32_t j = e.second;
      if (done[(size_t)j] || e.first > dist[(size_t)j]) continue;
      done[(size_t)j] = 1;
      if (match_col[(size_t)j] == -1) {
        jf = j;
        dmin = e.first;
        break;
      }
      int32_t r = match_col[(size_t)j];
      double base = e.first;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        int32_t j2 = indices[p];
        if (done[(size_t)j2]) continue;
        double nd = base + cost[p] - u[(size_t)r] - v[(size_t)j2];
        if (nd < dist[(size_t)j2]) {
          if (dist[(size_t)j2] == INF) touched.push_back(j2);
          dist[(size_t)j2] = nd;
          pred[(size_t)j2] = r;
          q.push({nd, j2});
        }
      }
    }
    if (jf == -1) {
      // restore scratch before reporting structural singularity
      for (int32_t j : touched) {
        dist[(size_t)j] = INF;
        pred[(size_t)j] = -1;
        done[(size_t)j] = 0;
      }
      return -1;
    }
    // dual update on the scanned set keeps reduced costs >= 0
    for (int32_t j : touched)
      if (done[(size_t)j] && j != jf) v[(size_t)j] += dist[(size_t)j] - dmin;
    // augment along pred chain
    int32_t j = jf;
    while (j != -1) {
      int32_t r = pred[(size_t)j];
      int32_t jnext = match_row[(size_t)r];
      match_row[(size_t)r] = j;
      match_col[(size_t)j] = r;
      j = jnext;
    }
    // restore u on matched rows of updated columns (rc(matched) == 0)
    for (int32_t jj : touched) {
      if (done[(size_t)jj]) {
        int32_t r = match_col[(size_t)jj];
        if (r != -1) {
          for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
            if (indices[p] == jj) {
              u[(size_t)r] = cost[p] - v[(size_t)jj];
              break;
            }
        }
      }
      dist[(size_t)jj] = INF;
      pred[(size_t)jj] = -1;
      done[(size_t)jj] = 0;
    }
  }
  for (int64_t i = 0; i < n; ++i) match_out[i] = match_row[(size_t)i];
  return 0;
}

}  // extern "C"
