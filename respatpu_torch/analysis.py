"""Host-side structural analysis for the band solver (numpy): the reverse
Cuthill-McKee ordering, symmetric permutation and the structural-symmetry
measure.

Own copies of what the direct-solve path needs from ``respatpu/analysis.py``
(``rcm_ordering``, ``permute_csr``, ``structural_symmetry``, ``ordering``).
The fill-reducing orderings, the ILU schedules and the GESP matching come
with the solvers that use them.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from .formats import COOMatrix, CSRMatrix, coo_to_csr

__all__ = ["rcm_ordering", "ordering", "permute_csr", "structural_symmetry",
           "symmetrized_adjacency"]

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


def ordering(a: CSRMatrix, method: str = "rcm") -> np.ndarray:
    """Dispatch: 'rcm' (bandwidth) or 'natural'. The fill-reducing orderings
    come with the multifrontal solver."""
    if method == "rcm":
        return rcm_ordering(a)
    if method == "natural":
        return np.arange(a.nrows, dtype=np.int32)
    if method in ("mindeg", "amd", "nd", "fillauto"):
        raise NotImplementedError(f"ordering {method!r} is not ported yet "
                                  "(multifrontal LU slice)")
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
