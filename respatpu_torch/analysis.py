"""Host-side structural analysis for the direct solvers (numpy, with the hot
loops in the port's native host library): orderings (reverse Cuthill-McKee
for the band; approximate minimum degree and nested dissection for the
multifrontal LU), symmetric permutation, the structural-symmetry measure,
symbolic fill, the GESP weighted matching with its scaling, and the ILU(0)
path's schedules: the level of every row of a triangular solve and the
Chow-Patel pair lists.

Own copies of what the direct-solve and ILU paths need from
``respatpu/analysis.py``; the same input gives the same arrays, except that
the pair lists are kept ragged (an offset an entry) rather than padded to the
longest list. The chunked triangular-solve layout (``build_tri_chunks``) is a
layout for a chip without gathers and is not ported: the card's triangular
solve reads the CSR as it is.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .formats import COOMatrix, CSRMatrix, coo_to_csr

__all__ = ["rcm_ordering", "mindeg_ordering", "nd_ordering", "fill_ordering",
           "ordering", "permute_csr", "structural_symmetry",
           "symmetrized_adjacency", "symbolic_fill_lu",
           "weighted_matching_scaling", "apply_matching_scaling",
           "level_schedule", "IluSchedule", "chow_patel_schedule"]

_USE_NATIVE = True  # False: always the Python breadth-first search


def _native_ok() -> bool:
    if not _USE_NATIVE:
        return False
    from .io import native
    return native.available()


def symmetrized_adjacency(a: CSRMatrix):
    """Pattern of A + A^T without the diagonal, as ``(indptr int64,
    indices int32)`` with each row's neighbours ascending (numpy; the native
    routine builds the same lists itself)."""
    n = a.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    off = rows != cols
    r = np.concatenate([rows[off], cols[off]])
    c = np.concatenate([cols[off], rows[off]])
    key = np.unique(r * n + c)
    r, c = key // max(n, 1), key % max(n, 1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return indptr, c.astype(np.int32)


def _rcm_bfs(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The ordering of ``io/csrc/rcm_order.cpp`` in Python: seeds by least
    degree (lowest index on a tie), neighbours by (degree, index)."""
    deg = np.diff(indptr)
    by_deg = np.argsort(deg, kind="stable")
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    next_seed = 0
    while pos < n:
        while visited[by_deg[next_seed]]:
            next_seed += 1
        start = int(by_deg[next_seed])
        queue = deque([start])
        visited[start] = True
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            nbs = indices[indptr[v]:indptr[v + 1]]
            nbs = nbs[~visited[nbs]]
            nbs = nbs[np.argsort(deg[nbs], kind="stable")]
            visited[nbs] = True
            queue.extend(nbs.tolist())
    return order[::-1].astype(np.int32).copy()


def rcm_ordering(a: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering on the symmetrized pattern.

    Bandwidth-reducing analogue of the reference's fill-reducing orderings
    (PARDISO iparm[1]=3 METIS, test_pardiso.c:139; get_perm_c(3,..),
    test_superLU_MT.c:161-163). The native routine and the Python search
    give the same order; the Python one walks a queue per vertex and takes
    seconds to minutes at n = 100,000.
    """
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"an ordering needs a square matrix, got {a.shape}")
    if _native_ok():
        from .io import native
        return native.rcm(a.nrows, a.indptr, a.indices)
    return _rcm_bfs(a.nrows, *symmetrized_adjacency(a))


def _symmetrized_csr(a: CSRMatrix) -> CSRMatrix:
    """A + A^T as a CSR pattern (diagonal kept), the orderings' input."""
    coo, coot = a.tocoo(), a.transpose().tocoo()
    return coo_to_csr(COOMatrix(a.shape,
                                np.concatenate([coo.row, coot.row]),
                                np.concatenate([coo.col, coot.col]),
                                np.ones(coo.nnz + coot.nnz)))


def mindeg_ordering(a: CSRMatrix) -> np.ndarray:
    """Minimum-degree fill-reducing ordering on the symmetrized pattern
    (the METIS/AMD slot of PARDISO iparm[1]=3 / get_perm_c(3,..)).

    The native quotient-graph AMD (Amestoy-Davis-Duff style: approximate
    external degrees, element absorption, supervariable merging,
    ``io/csrc/fill_order.cpp``); a naive Python minimum degree when the
    native library is unavailable.
    """
    n = a.nrows
    sym = _symmetrized_csr(a)
    if _native_ok():
        from .io import native
        return native.amd(n, sym.indptr, sym.indices)
    adj = [set(sym.indices[sym.indptr[i]:sym.indptr[i + 1]]) - {i}
           for i in range(n)]
    eliminated = np.zeros(n, bool)
    order = np.empty(n, dtype=np.int32)
    for pos in range(n):
        live = np.flatnonzero(~eliminated)
        v = live[int(np.argmin([len(adj[i]) for i in live]))]
        order[pos] = v
        nbrs = [u for u in adj[v] if not eliminated[u]]
        for u in nbrs:
            adj[u] |= set(nbrs)
            adj[u].discard(u)
            adj[u].discard(v)
        eliminated[v] = True
    return order


def nd_ordering(a: CSRMatrix, leaf_size: int = 256) -> np.ndarray:
    """Nested dissection (level-structure separators, AMD leaves): the
    METIS slot for large meshes (``io/csrc/fill_order.cpp``). On
    hub-dominated circuit graphs separators do not exist and ND fills far
    worse than AMD; :func:`fill_ordering` chooses by structure."""
    if _native_ok():
        from .io import native
        sym = _symmetrized_csr(a)
        return native.nd(a.nrows, sym.indptr, sym.indices, leaf_size)
    return mindeg_ordering(a)


def fill_ordering(a: CSRMatrix) -> np.ndarray:
    """Structure-aware fill-reducing ordering: nested dissection for large
    mesh-like graphs (near-uniform degrees, small separators), AMD
    otherwise (power-law/circuit graphs, where ND separators blow up).

    The discriminator is degree skew: corpus mesh classes have
    p99.9(degree)/mean < ~4 while circuit classes (hub nets) exceed 8."""
    n = a.nrows
    if n >= 20_000:
        deg = a.row_lengths().astype(np.float64)
        mean = max(float(deg.mean()), 1.0)
        if (float(np.percentile(deg, 99.9)) <= 8 * mean
                and float(deg.max()) <= 16 * mean):
            return nd_ordering(a)
    return mindeg_ordering(a)


def ordering(a: CSRMatrix, method: str = "rcm") -> np.ndarray:
    """Dispatch: 'rcm' (bandwidth), 'mindeg'/'amd' (fill, AMD), 'nd'
    (nested dissection), 'fillauto' (structure-aware ND/AMD), 'natural'."""
    if method in ("mindeg", "amd"):
        return mindeg_ordering(a)
    if method == "nd":
        return nd_ordering(a)
    if method == "fillauto":
        return fill_ordering(a)
    if method == "rcm":
        return rcm_ordering(a)
    if method == "natural":
        return np.arange(a.nrows, dtype=np.int32)
    raise ValueError(f"unknown ordering {method!r}")


def permute_csr(a: CSRMatrix, perm: np.ndarray,
                col_perm: Optional[np.ndarray] = None) -> CSRMatrix:
    """Symmetric (or two-sided) permutation: B = A[perm][:, col_perm or perm]."""
    if col_perm is None:
        col_perm = perm
    n = a.nrows
    inv_r = np.empty(n, dtype=np.int64)
    inv_r[perm] = np.arange(n)
    inv_c = np.empty(a.ncols, dtype=np.int64)
    inv_c[col_perm] = np.arange(a.ncols)
    coo = a.tocoo()
    return coo_to_csr(COOMatrix(a.shape,
                                inv_r[coo.row].astype(np.int32),
                                inv_c[coo.col].astype(np.int32),
                                coo.val))


def structural_symmetry(a: CSRMatrix) -> float:
    """Fraction of nonzero positions (i, j) whose mirror (j, i) is also
    stored.  1.0 = structurally symmetric.  Drives the auto-matching choice
    in ``solve.factorize`` (the reference enables PARDISO's weighted
    matching for unsymmetric matrices, test_pardiso.c:141 iparm[12]=1)."""
    if a.nnz == 0 or a.nrows != a.ncols:
        return 1.0
    n = a.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    key = np.sort(rows * n + cols)
    mirror = np.sort(cols * n + rows)
    pos = np.searchsorted(key, mirror)
    pos = np.minimum(pos, key.size - 1)
    return float(np.mean(key[pos] == mirror))


# ---------------------------------------------------------------------------
# Symbolic fill
# ---------------------------------------------------------------------------


def symbolic_fill_lu(a: CSRMatrix) -> CSRMatrix:
    """Symbolic LU factorization (no pivoting): pattern of L+U with fill.

    Returns a CSR whose pattern is the filled pattern (values = A's values
    scattered in, zeros at fill positions): the PARDISO phase-11 analogue,
    test_pardiso.c:185-187. With the native library this is the near-linear
    elimination-tree algorithm; unsymmetric patterns are symmetrized first
    (struct(L+U of A) is contained in the Cholesky fill of pattern(A + A^T),
    the standard GESP symbolic). Without it, the row-merge: the pattern of
    row i of the factor is the union of row i of A with the upper parts of
    all factor rows k in the lower part of row i, in increasing k.
    """
    n = a.nrows
    if _native_ok():
        from .io import native
        if structural_symmetry(a) == 1.0:
            work_indptr, work_indices = a.indptr, a.indices
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
            cols = a.indices.astype(np.int64)
            key = np.unique(np.concatenate([rows * n + cols, cols * n + rows]))
            work_indices = (key % n).astype(np.int32)
            counts = np.bincount((key // n).astype(np.int64), minlength=n)
            work_indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=work_indptr[1:])
        findptr, findices = native.symbolic_fill(n, work_indptr, work_indices)
        filled = CSRMatrix((n, n), findptr, findices,
                           np.zeros(findices.size, dtype=np.float64))
        _scatter_values(a, filled)
        return filled
    rows_out: List[np.ndarray] = []
    for i in range(n):
        s, e = a.indptr[i], a.indptr[i + 1]
        pattern = a.indices[s:e].astype(np.int64)
        if not (pattern == i).any():
            pattern = np.insert(pattern, np.searchsorted(pattern, i), i)
        t = 0
        while True:  # transitive row-merge in increasing k
            low = pattern[(pattern < i)]
            if t >= low.size:
                break
            k = low[t]
            t += 1
            rk = rows_out[k]
            upper_k = rk[rk > k]
            if upper_k.size:
                pattern = np.union1d(pattern, upper_k)
        rows_out.append(pattern)
    lens = np.array([r.size for r in rows_out], dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate(rows_out) if n else np.empty(0, np.int64)
    filled = CSRMatrix((n, n), indptr, indices.astype(np.int32),
                       np.zeros(indices.size, dtype=np.float64))
    _scatter_values(a, filled)
    return filled


def _scatter_values(a: CSRMatrix, filled: CSRMatrix) -> None:
    """Scatter A's values into the (super)pattern of ``filled`` (vectorized)."""
    # filled.indices is sorted per row: offset columns by row * (ncols + 1)
    # and one global searchsorted finds every entry of A
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())
    ncols = a.ncols + 1
    fkeys = np.repeat(np.arange(filled.nrows, dtype=np.int64),
                      np.diff(filled.indptr)) * ncols + filled.indices
    akeys = rows * ncols + a.indices
    filled.data[np.searchsorted(fkeys, akeys)] = a.data


# ---------------------------------------------------------------------------
# GESP static pivoting: weighted matching and scaling
# ---------------------------------------------------------------------------


def weighted_matching_scaling(a: CSRMatrix, ruiz_iters: int = 5):
    """MC64-style weighted matching + equilibration for static pivoting.

    The reference enables PARDISO's weighted matching for unsymmetric
    matrices (test_pardiso.c:141, iparm[12]=1); MUMPS does the same through
    its ICNTL(6) preprocessing. On a static-pattern factorization
    a-posteriori row pivoting is impossible, so the numerically robust
    recipe for circuit-class matrices is: permute columns so the matched
    (max-product) entries land on the diagonal, scale so they are ~1 in
    magnitude, then factor with static perturbation and recover accuracy
    with fp64 iterative refinement (Li & Demmel, GESP).

    Returns ``(cperm, dr, dc, matched_ok)`` such that
    ``A'[i, j] = dr[i] * A[i, cperm[j]] * dc[j]`` has a large diagonal:
    solve ``A' x' = dr * b`` then ``x[cperm] = dc * x'``.
    ``matched_ok`` is False when the matrix is structurally singular (no
    full matching exists) and the identity matching was substituted;
    callers must surface this in their reports.
    """
    n, m = a.shape
    if n != m:
        raise ValueError(f"matching needs a square matrix, got {a.shape}")
    absa = np.abs(a.data)
    # max-product matching == min-sum of -log|a_ij| (normalized per row so
    # weights are bounded)
    rows = np.repeat(np.arange(n), a.row_lengths())
    rmax = np.zeros(n)
    np.maximum.at(rmax, rows, absa)
    rmax = np.where(rmax > 0, rmax, 1.0)
    wlog = -np.log(np.maximum(absa / rmax[rows], 1e-300))
    matched_ok = True
    if _native_ok():
        from .io import native
        mr = native.sparse_assignment(n, a.indptr, a.indices, wlog)
        if mr is not None:
            rperm_of = mr.astype(np.int64)
        else:
            rperm_of = np.arange(n, dtype=np.int64)
            matched_ok = False
    else:
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import min_weight_full_bipartite_matching
        # strictly positive weights (0 means "no edge" in the sparse API)
        big = _sp.csr_matrix((wlog + 1.0, a.indices, a.indptr), shape=(n, m))
        try:
            rr, cc = min_weight_full_bipartite_matching(big)
            rperm_of = np.empty(n, dtype=np.int64)
            rperm_of[rr] = cc                   # row i matched to col
        except ValueError:
            rperm_of = np.arange(n, dtype=np.int64)
            matched_ok = False
    # cperm: column placed at diagonal position i is rperm_of[i]
    cperm = rperm_of.astype(np.int64)
    # scale matched entries to ~1, then Ruiz-equilibrate the rest
    key = rows * np.int64(m) + a.indices.astype(np.int64)
    want = np.arange(n, dtype=np.int64) * m + cperm
    pos = np.searchsorted(key, want)
    pos = np.minimum(pos, max(key.size - 1, 0))
    hit = key[pos] == want if key.size else np.zeros(n, bool)
    dval = np.where(hit, np.abs(a.data[pos]), 1.0)
    dval = np.where(dval > 0, dval, 1.0)
    dr = 1.0 / np.sqrt(dval)
    dc_perm_inv = np.empty(n, dtype=np.int64)
    dc_perm_inv[cperm] = np.arange(n)
    dc = dr.copy()  # symmetric split of the matched magnitude
    # Ruiz iterations on the scaled+permuted matrix (inf-norm equilibration)
    colpos = dc_perm_inv[a.indices]             # column j of A -> position
    for _ in range(ruiz_iters):
        v = dr[rows] * np.abs(a.data) * dc[colpos]
        rn = np.zeros(n)
        np.maximum.at(rn, rows, v)
        cn = np.zeros(n)
        np.maximum.at(cn, colpos, v)
        rn = np.where(rn > 0, rn, 1.0)
        cn = np.where(cn > 0, cn, 1.0)
        dr = dr / np.sqrt(rn)
        dc = dc / np.sqrt(cn)
    return cperm, dr, dc, matched_ok


def apply_matching_scaling(a: CSRMatrix, cperm: np.ndarray, dr: np.ndarray,
                           dc: np.ndarray) -> CSRMatrix:
    """A'[i, j] = dr[i] * A[i, cperm[j]] * dc[j] (CSR, sorted indices)."""
    inv = np.empty(cperm.size, dtype=np.int64)
    inv[cperm] = np.arange(cperm.size)
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    newcol = inv[a.indices]
    vals = dr[rows] * a.data * dc[newcol]
    order = np.lexsort((newcol, rows))
    return CSRMatrix(a.shape, a.indptr.astype(np.int64),
                     newcol[order].astype(np.int32), vals[order])


# ---------------------------------------------------------------------------
# ILU(0) schedules
# ---------------------------------------------------------------------------


def level_schedule(l_csr: CSRMatrix, upper: bool = False) -> np.ndarray:
    """Level (wavefront) of each row for triangular solve dependency DAG.

    Row i of a lower-triangular solve depends on rows j<i present in row i's
    pattern; level[i] = 1 + max(level[deps]), level 0 for independent rows.
    For ``upper=True`` the same is computed on the reversed system.

    Equivalent of the level-set construction inside ``csrsv2_analysis``
    (GPU/ilu0.cu:228-252).
    """
    n = l_csr.nrows
    indptr, indices = l_csr.indptr, l_csr.indices
    if _native_ok():
        from .io import native
        return native.level_schedule(n, indptr, indices, lower=not upper)
    level = np.zeros(n, dtype=np.int32)
    rows = range(n) if not upper else range(n - 1, -1, -1)
    for i in rows:
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        deps = cols[cols < i] if not upper else cols[cols > i]
        if deps.size:
            level[i] = level[deps].max() + 1
    return level


@dataclass
class IluSchedule:
    """Schedule for fixed-point ILU(0) sweeps (Chow & Patel 2015).

    For each stored entry p=(i,j) of A, ``pairs_a[ptr[p]:ptr[p+1]]`` and
    ``pairs_b[ptr[p]:ptr[p+1]]`` list the nnz positions of l_ik and u_kj for
    every k < min(i, j) present in both patterns, k ascending. One sweep
    updates all entries from the previous values:

        s   = a_ij - sum_t val[pairs_a] * val[pairs_b]
        val[p] = s / val[diag_of_col_j]   if i > j   (L entry)
        val[p] = s                        otherwise  (U entry, diag included)

    The fixed point of this iteration is exactly ILU(0). respatpu pads every
    entry's list to ``t_max``; here the lists are ragged, so a hub row costs
    only its own pairs.
    """

    nnz: int
    t_max: int
    ptr: np.ndarray  # int64[nnz+1]: entry p's pairs are ptr[p] .. ptr[p+1]-1
    pairs_a: np.ndarray  # int64[npairs] (positions of l_ik)
    pairs_b: np.ndarray  # int64[npairs] (positions of u_kj)
    is_lower: np.ndarray  # bool[nnz]
    diag_pos_col: np.ndarray  # int64[nnz]: nnz position of u_jj for this entry's column
    diag_pos: np.ndarray  # int64[n]: position of each row's diagonal entry
    zero_diag: np.ndarray  # bool[n]: structurally missing diagonal (breakdown)

    @property
    def npairs(self) -> int:
        return int(self.ptr[-1])

    def layout_bytes(self, index_bytes: int = 4) -> dict:
        """Bytes of the pair lists on the device, ragged (as here) and padded
        to ``t_max`` (as respatpu stores them), with ``index_bytes``-wide
        positions and an int64 offset an entry."""
        return {"ragged": 2 * self.npairs * index_bytes + 8 * (self.nnz + 1),
                "padded": 2 * self.nnz * self.t_max * index_bytes}


def chow_patel_schedule(a: CSRMatrix) -> IluSchedule:
    """Build intersection lists for Chow-Patel ILU(0) sweeps (host)."""
    n = a.nrows
    indptr, indices = a.indptr, a.indices
    nnz = a.nnz
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = indices.astype(np.int64)

    diag_pos = np.full(n, -1, dtype=np.int64)
    dmask = rows == cols
    diag_pos[rows[dmask]] = np.flatnonzero(dmask)
    zero_diag = diag_pos < 0

    # column-wise structure: positions sorted by (col, row)
    col_order = np.lexsort((rows, cols))
    col_start = np.searchsorted(cols[col_order], np.arange(n + 1))

    if _native_ok():
        from .io import native
        ptr, pa, pb, t_max = native.cp_schedule(n, indptr, indices, col_start,
                                                rows[col_order], col_order)
    else:
        lists_a: List[np.ndarray] = []
        lists_b: List[np.ndarray] = []
        for p in range(nnz):
            i, j = rows[p], cols[p]
            kmax = min(i, j)
            s, e = indptr[i], indptr[i + 1]
            row_cols = cols[s:e]
            lsel = row_cols < kmax
            pos_row = np.arange(s, e, dtype=np.int64)[lsel]
            cs, ce = col_start[j], col_start[j + 1]
            col_rows = rows[col_order[cs:ce]]
            usel = col_rows < kmax
            pos_col = col_order[cs:ce][usel]
            _, ia, ib = np.intersect1d(row_cols[lsel], col_rows[usel], assume_unique=True,
                                       return_indices=True)
            lists_a.append(pos_row[ia])
            lists_b.append(pos_col[ib])
        counts = np.array([x.size for x in lists_a], dtype=np.int64)
        ptr = np.zeros(nnz + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        pa = np.concatenate(lists_a) if nnz else np.zeros(0, np.int64)
        pb = np.concatenate(lists_b) if nnz else np.zeros(0, np.int64)
        t_max = int(counts.max()) if nnz else 0

    return IluSchedule(
        nnz=nnz, t_max=max(int(t_max), 1), ptr=ptr, pairs_a=pa.astype(np.int64),
        pairs_b=pb.astype(np.int64), is_lower=(rows > cols),
        diag_pos_col=diag_pos[np.clip(cols, 0, n - 1)],
        diag_pos=diag_pos, zero_diag=zero_diag,
    )
