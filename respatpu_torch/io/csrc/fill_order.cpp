// Fill-reducing orderings (host): approximate minimum degree on the quotient
// graph, and nested dissection with minimum-degree leaves.
//
// The port's own copies of the routines the JAX package keeps in its host
// library; the same input gives the same order. Both take a symmetric
// pattern in CSR (the caller symmetrizes) and write the elimination order
// (order_out[k] = k-th pivot).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

namespace {

// AMD: approximate minimum degree on the quotient graph, the role METIS/AMD
// play inside the reference's backends (PARDISO iparm[1], test_pardiso.c:139;
// get_perm_c(3,..), test_superLU_MT.c:161-163). The standard quotient-graph
// algorithm of Amestoy, Davis & Duff (1996):
//   * eliminated pivots become ELEMENTS; a variable's adjacency is its
//     remaining original edges plus its element list, so memory stays O(nnz);
//   * external degrees are APPROXIMATED with the two-pass |Le \ Lp| counter
//     scan (the "w" trick), never recomputed exactly;
//   * elements fully covered by the new pivot element are absorbed;
//   * variables with identical adjacency merge into supervariables
//     (hash + exact compare), eliminating together;
//   * rows dense in the ORIGINAL matrix (> max(16, a*sqrt(n)) entries) are
//     deferred to the end, classified up front.
int amd_core(int64_t n, const int64_t* indptr, const int32_t* indices,
             int32_t* order_out, double dense_alpha) {
  if (n == 0) return 0;
  enum { LIVE = 0, ELEM = 1, ABSORBED = 2, DENSE = 3, DONE = 4 };
  std::vector<int8_t> state((size_t)n, LIVE);
  std::vector<std::vector<int32_t>> vlist((size_t)n);  // var: original edges
                                                       // elem: its live vars
  std::vector<std::vector<int32_t>> elist((size_t)n);  // var: adjacent elems
  std::vector<int32_t> nv((size_t)n, 1);     // supervariable weight
  std::vector<int32_t> par((size_t)n);       // absorbed -> representative
  std::vector<int32_t> chain_head((size_t)n), chain_next((size_t)n, -1),
      chain_tail((size_t)n);
  std::vector<int64_t> deg((size_t)n);       // approximate external degree
  std::vector<int64_t> esize((size_t)n, 0);  // element weighted size cache
  std::vector<int64_t> wstamp((size_t)n, 0), wval((size_t)n, 0);
  std::vector<int64_t> stamp((size_t)n, 0);
  int64_t mark = 0;
  for (int64_t i = 0; i < n; ++i) {
    par[(size_t)i] = (int32_t)i;
    chain_head[(size_t)i] = (int32_t)i;
    chain_tail[(size_t)i] = (int32_t)i;
  }

  // resolve absorbed supervariables (path compression)
  std::vector<int32_t> pathbuf;
  auto resolve = [&](int32_t v) -> int32_t {
    while (par[(size_t)v] != v) {
      pathbuf.push_back(v);
      v = par[(size_t)v];
    }
    for (int32_t u : pathbuf) par[(size_t)u] = v;
    pathbuf.clear();
    return v;
  };

  // initial adjacency + degrees; classify dense rows up front
  int64_t dense_thr = (int64_t)std::max(
      16.0, dense_alpha * std::sqrt((double)n));
  std::vector<int32_t> dense_nodes;
  typedef std::pair<int64_t, int32_t> Ent;
  std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> heap;
  for (int64_t i = 0; i < n; ++i) {
    auto& a = vlist[(size_t)i];
    a.reserve((size_t)(indptr[i + 1] - indptr[i]));
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (indices[p] != (int32_t)i) a.push_back(indices[p]);
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    deg[(size_t)i] = (int64_t)a.size();
    if (deg[(size_t)i] > dense_thr) {
      state[(size_t)i] = DENSE;
      dense_nodes.push_back((int32_t)i);
    } else {
      heap.push({deg[(size_t)i], (int32_t)i});
    }
  }

  int64_t pos = 0;
  std::vector<int32_t> Lp, tmp;
  // per-step supervariable hash buckets (cleared each elimination)
  std::vector<std::pair<uint64_t, int32_t>> hashes;

  auto emit = [&](int32_t v) {
    for (int32_t u = chain_head[(size_t)v]; u != -1;
         u = chain_next[(size_t)u])
      order_out[pos++] = u;
  };

  // compact a var's element list: drop dead elements, dedup
  auto clean_elist = [&](int32_t v) {
    auto& el = elist[(size_t)v];
    size_t o = 0;
    ++mark;
    for (int32_t e : el)
      if (state[(size_t)e] == ELEM && stamp[(size_t)e] != mark) {
        stamp[(size_t)e] = mark;
        el[o++] = e;
      }
    el.resize(o);
  };
  while (pos < n && !heap.empty()) {
    Ent top = heap.top();
    heap.pop();
    int32_t p = top.second;
    if (state[(size_t)p] != LIVE || top.first != deg[(size_t)p]) continue;

    // ---- build Lp = live neighbourhood of p (vars + element members) ----
    Lp.clear();
    ++mark;
    stamp[(size_t)p] = mark;
    int64_t lp_weight = 0;
    for (int32_t u : vlist[(size_t)p]) {
      int32_t r = resolve(u);
      if ((state[(size_t)r] == LIVE || state[(size_t)r] == DENSE) &&
          stamp[(size_t)r] != mark) {
        stamp[(size_t)r] = mark;
        Lp.push_back(r);
        lp_weight += nv[(size_t)r];
      }
    }
    for (int32_t e : elist[(size_t)p]) {
      if (state[(size_t)e] != ELEM) continue;
      for (int32_t u : vlist[(size_t)e]) {
        int32_t r = resolve(u);
        if ((state[(size_t)r] == LIVE || state[(size_t)r] == DENSE) &&
            stamp[(size_t)r] != mark) {
          stamp[(size_t)r] = mark;
          Lp.push_back(r);
          lp_weight += nv[(size_t)r];
        }
      }
      state[(size_t)e] = DONE;  // absorbed into the new element
      vlist[(size_t)e].clear();
      vlist[(size_t)e].shrink_to_fit();
    }

    // ---- p becomes element p with members Lp ----
    state[(size_t)p] = ELEM;
    vlist[(size_t)p] = Lp;
    elist[(size_t)p].clear();
    elist[(size_t)p].shrink_to_fit();
    esize[(size_t)p] = lp_weight;

    // ---- prune member lists; Lp-internal edges now live in element p ----
    ++mark;
    for (int32_t v : Lp) stamp[(size_t)v] = mark;
    for (int32_t v : Lp) {
      auto& vl = vlist[(size_t)v];
      size_t o = 0;
      for (int32_t u : vl) {
        int32_t r = resolve(u);
        if ((state[(size_t)r] == LIVE || state[(size_t)r] == DENSE) &&
            stamp[(size_t)r] != mark && r != v)
          vl[o++] = r;
      }
      vl.resize(o);
      clean_elist(v);
      elist[(size_t)v].push_back(p);
    }

    // ---- two-pass approximate degree (the AMD |Le \ Lp| counters) ----
    ++mark;
    for (int32_t v : Lp) {
      for (int32_t e : elist[(size_t)v]) {
        if (e == p || state[(size_t)e] != ELEM) continue;
        if (wstamp[(size_t)e] != mark) {
          wstamp[(size_t)e] = mark;
          wval[(size_t)e] = esize[(size_t)e];
        }
        wval[(size_t)e] -= nv[(size_t)v];
      }
    }
    hashes.clear();
    for (int32_t v : Lp) {
      if (state[(size_t)v] == DENSE) continue;  // deferred: no degree upkeep
      int64_t ext_a = 0;
      uint64_t h = 1469598103934665603ull;
      for (int32_t u : vlist[(size_t)v]) {
        ext_a += nv[(size_t)u];
        h = (h ^ (uint64_t)u) * 1099511628211ull;
      }
      int64_t dsum = 0;
      auto& el = elist[(size_t)v];
      size_t o = 0;
      for (int32_t e : el) {
        if (state[(size_t)e] != ELEM) continue;
        if (e != p && wstamp[(size_t)e] == mark && wval[(size_t)e] <= 0) {
          // e is covered by the new element: absorb it
          state[(size_t)e] = DONE;
          vlist[(size_t)e].clear();
          vlist[(size_t)e].shrink_to_fit();
          continue;
        }
        el[o++] = e;
        if (e != p)
          dsum += (wstamp[(size_t)e] == mark) ? std::max<int64_t>(wval[(size_t)e], 0)
                                              : esize[(size_t)e];
        h = (h ^ (uint64_t)(e + n)) * 1099511628211ull;
      }
      el.resize(o);
      int64_t d_lp = lp_weight - nv[(size_t)v];
      int64_t d_new = std::min(
          std::min((int64_t)(n - pos) - nv[(size_t)v],
                   deg[(size_t)v] + d_lp),
          ext_a + d_lp + dsum);
      deg[(size_t)v] = std::max<int64_t>(d_new, 0);
      hashes.push_back({h, v});
    }

    // ---- supervariable detection: equal hash -> exact adjacency compare ----
    if (hashes.size() > 1) {
      std::sort(hashes.begin(), hashes.end());
      for (size_t i = 0; i + 1 < hashes.size(); ++i) {
        int32_t v = hashes[i].second;
        if (state[(size_t)v] != LIVE) continue;
        for (size_t j = i + 1;
             j < hashes.size() && hashes[j].first == hashes[i].first; ++j) {
          int32_t u = hashes[j].second;
          if (state[(size_t)u] != LIVE) continue;
          if (vlist[(size_t)v].size() != vlist[(size_t)u].size() ||
              elist[(size_t)v].size() != elist[(size_t)u].size())
            continue;
          // lists were just pruned+resolved; compare as sorted sets
          tmp = vlist[(size_t)v];
          std::sort(tmp.begin(), tmp.end());
          auto tv = tmp;
          tmp = vlist[(size_t)u];
          std::sort(tmp.begin(), tmp.end());
          if (tmp != tv) continue;
          tmp = elist[(size_t)v];
          std::sort(tmp.begin(), tmp.end());
          auto te = tmp;
          tmp = elist[(size_t)u];
          std::sort(tmp.begin(), tmp.end());
          if (tmp != te) continue;
          // merge u into v
          nv[(size_t)v] += nv[(size_t)u];
          nv[(size_t)u] = 0;
          state[(size_t)u] = ABSORBED;
          par[(size_t)u] = v;
          chain_next[(size_t)chain_tail[(size_t)v]] = chain_head[(size_t)u];
          chain_tail[(size_t)v] = chain_tail[(size_t)u];
          vlist[(size_t)u].clear();
          vlist[(size_t)u].shrink_to_fit();
          elist[(size_t)u].clear();
          elist[(size_t)u].shrink_to_fit();
        }
      }
    }

    // ---- emit pivot supervariable; requeue updated members ----
    emit(p);
    for (int32_t v : Lp)
      if (state[(size_t)v] == LIVE) heap.push({deg[(size_t)v], v});
  }

  // deferred dense rows last, by original degree; plus any stragglers
  std::sort(dense_nodes.begin(), dense_nodes.end(),
            [&](int32_t a, int32_t b) {
              int64_t da = indptr[a + 1] - indptr[a];
              int64_t db = indptr[b + 1] - indptr[b];
              return da != db ? da < db : a < b;
            });
  for (int32_t v : dense_nodes)
    if (state[(size_t)v] == DENSE) {
      state[(size_t)v] = DONE;
      emit(v);
    }
  for (int64_t v = 0; v < n && pos < n; ++v)
    if (state[(size_t)v] == LIVE) {
      state[(size_t)v] = DONE;
      emit((int32_t)v);
    }
  return pos == n ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Nested dissection ordering (level-structure separators, AMD leaves)
// ---------------------------------------------------------------------------
// The METIS slot for large 3-D meshes, where minimum-degree orderings fill
// asymptotically worse than separator-based ones.  Classical scheme
// (George's gennd family): find a pseudo-peripheral vertex by repeated
// BFS, take a middle BFS level as a vertex separator, recurse on the two
// halves, and eliminate the separator LAST; subgraphs at or below
// ``leaf_size`` are ordered by the quotient-graph AMD above (hybrid ND+AMD,
// the arrangement every production ordering package uses).  Implemented
// iteratively with an explicit work stack; disconnected pieces are handled
// per component.
int nd_core(int64_t n, const int64_t* indptr, const int32_t* indices,
            int32_t* order_out, int32_t leaf_size) {
  if (leaf_size <= 0) leaf_size = 256;
  if (n == 0) return 0;
  std::vector<int32_t> comp_buf;       // current subset
  std::vector<int32_t> level((size_t)n, -1);
  std::vector<int32_t> bfs;            // scratch BFS queue
  std::vector<int64_t> sub_indptr;
  std::vector<int32_t> sub_indices, sub_order, local_id((size_t)n, -1);
  int64_t pos = 0;

  // work stack: (subset vector, emitted_at) — separators are appended to
  // `pending` AFTER both halves via an explicit two-phase entry
  struct Task {
    std::vector<int32_t> verts;
    bool is_emit;  // emit verts verbatim (separator, post-children)
  };
  std::vector<Task> stack;
  // seed: whole graph as one subset
  {
    Task t;
    t.verts.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i) t.verts[(size_t)i] = (int32_t)i;
    t.is_emit = false;
    stack.push_back(std::move(t));
  }
  std::vector<char> in_sub((size_t)n, 0);

  while (!stack.empty()) {
    Task task = std::move(stack.back());
    stack.pop_back();
    std::vector<int32_t>& vs = task.verts;
    if (task.is_emit) {
      for (int32_t v : vs) order_out[pos++] = v;
      continue;
    }
    if ((int64_t)vs.size() <= leaf_size) {
      // induced subgraph -> AMD
      sub_indptr.assign(vs.size() + 1, 0);
      for (size_t k = 0; k < vs.size(); ++k) local_id[(size_t)vs[k]] = (int32_t)k;
      sub_indices.clear();
      for (size_t k = 0; k < vs.size(); ++k) {
        int32_t v = vs[k];
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int32_t u = indices[p];
          if (local_id[(size_t)u] >= 0 && u != v)
            sub_indices.push_back(local_id[(size_t)u]);
        }
        sub_indptr[k + 1] = (int64_t)sub_indices.size();
      }
      sub_order.assign(vs.size(), 0);
      amd_core((int64_t)vs.size(), sub_indptr.data(), sub_indices.data(),
                sub_order.data(), 10.0);
      for (size_t k = 0; k < vs.size(); ++k)
        order_out[pos++] = vs[(size_t)sub_order[k]];
      for (int32_t v : vs) local_id[(size_t)v] = -1;
      continue;
    }
    // mark membership; find a connected component of the subset
    for (int32_t v : vs) in_sub[(size_t)v] = 1;
    // BFS 1 from vs[0] (restricted to subset) to find the far end, BFS 2
    // from there for the level structure (pseudo-peripheral heuristic)
    int32_t start = vs[0];
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int32_t v : vs) level[(size_t)v] = -1;
      bfs.clear();
      bfs.push_back(start);
      level[(size_t)start] = 0;
      for (size_t h = 0; h < bfs.size(); ++h) {
        int32_t v = bfs[h];
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int32_t u = indices[p];
          if (in_sub[(size_t)u] && level[(size_t)u] < 0) {
            level[(size_t)u] = level[(size_t)v] + 1;
            bfs.push_back(u);
          }
        }
      }
      start = bfs.back();  // deepest vertex of this sweep
    }
    if (bfs.size() < vs.size()) {
      // disconnected: split into the reached component and the rest
      Task rest;
      rest.is_emit = false;
      for (int32_t v : vs)
        if (level[(size_t)v] < 0) rest.verts.push_back(v);
      Task comp;
      comp.is_emit = false;
      comp.verts.assign(bfs.begin(), bfs.end());
      for (int32_t v : vs) in_sub[(size_t)v] = 0;
      stack.push_back(std::move(rest));
      stack.push_back(std::move(comp));
      continue;
    }
    int32_t maxlev = 0;
    for (int32_t v : vs) maxlev = std::max(maxlev, level[(size_t)v]);
    if (maxlev < 2) {
      // diameter too small to separate: fall back to AMD on this subset
      for (int32_t v : vs) in_sub[(size_t)v] = 0;
      Task leaf;
      leaf.verts = std::move(vs);
      leaf.is_emit = false;
      // force the leaf path regardless of size by ordering inline
      sub_indptr.assign(leaf.verts.size() + 1, 0);
      for (size_t k = 0; k < leaf.verts.size(); ++k)
        local_id[(size_t)leaf.verts[k]] = (int32_t)k;
      sub_indices.clear();
      for (size_t k = 0; k < leaf.verts.size(); ++k) {
        int32_t v = leaf.verts[k];
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int32_t u = indices[p];
          if (local_id[(size_t)u] >= 0 && u != v)
            sub_indices.push_back(local_id[(size_t)u]);
        }
        sub_indptr[k + 1] = (int64_t)sub_indices.size();
      }
      sub_order.assign(leaf.verts.size(), 0);
      amd_core((int64_t)leaf.verts.size(), sub_indptr.data(),
                sub_indices.data(), sub_order.data(), 10.0);
      for (size_t k = 0; k < leaf.verts.size(); ++k)
        order_out[pos++] = leaf.verts[(size_t)sub_order[k]];
      for (int32_t v : leaf.verts) local_id[(size_t)v] = -1;
      continue;
    }
    // choose the separator level: smallest level set whose split stays
    // within a 30/70 balance
    std::vector<int64_t> lcount((size_t)maxlev + 1, 0);
    for (int32_t v : vs) lcount[(size_t)level[(size_t)v]]++;
    int64_t total = (int64_t)vs.size();
    int32_t best_l = maxlev / 2;
    double best_score = 1e300;
    int64_t below = 0;
    for (int32_t l = 1; l < maxlev; ++l) {
      below += lcount[(size_t)l - 1];
      int64_t above = total - below - lcount[(size_t)l];
      double bal = (double)std::min(below, above) /
                   (double)std::max<int64_t>(std::max(below, above), 1);
      if (bal < 0.25) continue;
      double score = (double)lcount[(size_t)l] / (0.1 + bal);
      if (score < best_score) {
        best_score = score;
        best_l = l;
      }
    }
    Task sep, lo, hi;
    sep.is_emit = true;
    lo.is_emit = hi.is_emit = false;
    for (int32_t v : vs) {
      int32_t l = level[(size_t)v];
      if (l < best_l) lo.verts.push_back(v);
      else if (l > best_l) hi.verts.push_back(v);
      else sep.verts.push_back(v);
    }
    for (int32_t v : vs) in_sub[(size_t)v] = 0;
    // stack is LIFO: push separator first so it EMITS last
    stack.push_back(std::move(sep));
    stack.push_back(std::move(hi));
    stack.push_back(std::move(lo));
  }
  return pos == n ? 0 : -1;
}

}  // namespace

extern "C" {

int amd_order(int64_t n, const int64_t* indptr, const int32_t* indices,
              int32_t* order_out, double dense_alpha) {
  return amd_core(n, indptr, indices, order_out, dense_alpha);
}

int nd_order(int64_t n, const int64_t* indptr, const int32_t* indices,
             int32_t* order_out, int32_t leaf_size) {
  return nd_core(n, indptr, indices, order_out, leaf_size);
}

}  // extern "C"
