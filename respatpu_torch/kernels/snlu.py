"""Supernodal multifrontal sparse LU: symbolic analysis + host numeric oracle.

The counterpart of ``respatpu/kernels/snlu.py`` (the same input gives the same
partition): the PARDISO-class direct path for patterns whose dense band
(kernels/bandlu.py) does not fit in memory. Pipeline (standard multifrontal
theory: Duff/Reid; Liu's supernode relaxations):

  1. fill-reducing ordering (analysis.ordering: minimum degree / nested
     dissection),
  2. pattern symmetrization + exact symbolic fill (analysis.symbolic_fill_lu,
     the PARDISO phase-11 slot, test_pardiso.c:185-187),
  3. elimination tree + postorder relabelling,
  4. fundamental supernode partition (parent[j]=j+1 and
     colcount[j]=colcount[j+1]+1) with relaxed amalgamation,
  5. per-supernode dense *frontal* factorization with extend-add of child
     Schur complements.

This module holds the symbolic machinery, which the device numeric phase
(kernels/snlu_device.py) builds its plan from, and a NumPy numeric
multifrontal (factor + solve) that is the port's independent check on the
CPU; nothing on the card path calls it.

No pivoting: like the band path, tiny pivots are perturbed (PARDISO-style,
test_pardiso.c:144-148) and accuracy is recovered with mixed-precision
iterative refinement (solve.solve_refined).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from ..analysis import ordering, permute_csr, symbolic_fill_lu
from ..formats import COOMatrix, CSRMatrix, coo_to_csr

__all__ = ["SupernodePartition", "analyze_supernodes", "etree", "postorder",
           "MultifrontalFactor", "multifrontal_factor", "multifrontal_solve"]


def etree(filled: CSRMatrix) -> np.ndarray:
    """Elimination tree of a filled (symmetric-pattern) factor:
    parent[j] = min{i > j : L[i, j] != 0}; -1 for roots."""
    n = filled.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), filled.row_lengths())
    cols = filled.indices.astype(np.int64)
    low = rows > cols
    parent = np.full(n, n, dtype=np.int64)
    np.minimum.at(parent, cols[low], rows[low])
    parent[parent == n] = -1
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the elimination forest (children before parents)."""
    n = parent.size
    children: List[List[int]] = [[] for _ in range(n)]
    roots: List[int] = []
    for v in range(n):
        p = parent[v]
        if p < 0:
            roots.append(v)
        else:
            children[p].append(v)
    post = np.empty(n, dtype=np.int64)
    k = 0
    for root in roots:
        stack = [(root, 0)]
        while stack:
            v, ci = stack.pop()
            if ci < len(children[v]):
                stack.append((v, ci + 1))
                stack.append((children[v][ci], 0))
            else:
                post[k] = v
                k += 1
    assert k == n, "elimination forest traversal incomplete (cycle?)"
    return post


@dataclasses.dataclass
class SupernodePartition:
    """Host symbolic result: everything the numeric phase (host oracle and
    device fronts) needs, as static arrays."""

    n: int
    perm: np.ndarray  # combined fill-reducing + postorder permutation
    filled: CSRMatrix  # filled pattern (permuted space) with A values
    snode_ptr: np.ndarray  # int64[nsn+1] supernode column ranges
    sn_parent: np.ndarray  # int64[nsn] parent supernode (-1 root)
    rowstruct: List[np.ndarray]  # per snode: rows strictly below its columns
    levels: List[np.ndarray]  # tree-level batches (independent fronts)
    fill_nnz: int

    @property
    def nsn(self) -> int:
        return self.snode_ptr.size - 1

    def front_sizes(self) -> np.ndarray:
        w = np.diff(self.snode_ptr)
        r = np.array([rs.size for rs in self.rowstruct], dtype=np.int64)
        return w + r


def _symmetrize_pattern(a: CSRMatrix) -> CSRMatrix:
    """Union pattern of A and A^T carrying A's values (zeros at new slots)."""
    coo = a.tocoo()
    n = a.nrows
    both = coo_to_csr(COOMatrix(
        (n, n),
        np.concatenate([coo.row, coo.col]),
        np.concatenate([coo.col, coo.row]),
        np.concatenate([coo.val, np.zeros(coo.val.size)])))
    # duplicate summing keeps A values where present (transpose adds 0)
    return both


def analyze_supernodes(a: CSRMatrix, order: str = "fillauto",
                       amalg: int = 32) -> SupernodePartition:
    """Symbolic multifrontal analysis (PARDISO phase-11 equivalent)."""
    n = a.nrows
    perm0 = ordering(a, order)
    ap = permute_csr(a, perm0)
    sym = _symmetrize_pattern(ap)
    filled0 = symbolic_fill_lu(sym)
    par0 = etree(filled0)
    post = postorder(par0)
    # relabel by postorder and redo symbolic on the relabelled matrix
    # (pattern is isomorphic; recomputing keeps every structure consistent)
    perm = perm0[post]
    ap2 = permute_csr(a, perm)
    filled = symbolic_fill_lu(_symmetrize_pattern(ap2))
    parent = etree(filled)

    # The filled pattern is structurally symmetric, so column j of the lower
    # factor is row j of the upper one: the upper entries in CSR order are the
    # lower entries sorted by (column, row), with no sort (respatpu sorts).
    rows = np.repeat(np.arange(n, dtype=np.int64), filled.row_lengths())
    cols = filled.indices.astype(np.int64)
    up = cols > rows
    lc, lr = rows[up], cols[up]
    del rows, cols, up
    colcount = np.bincount(lc, minlength=n)

    # fundamental supernodes
    starts = [0]
    for j in range(1, n):
        if not (parent[j - 1] == j and colcount[j - 1] == colcount[j] + 1):
            starts.append(j)
    snode_ptr = np.array(starts + [n], dtype=np.int64)

    # column structures of the filled lower factor (grouped by column)
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=cstart[1:])

    def snode_struct(ptr: np.ndarray) -> List[np.ndarray]:
        # The columns of a fundamental supernode nest (struct(j) = {j + 1} +
        # struct(j + 1)), so the union of their structures below the
        # supernode is what its first column holds there: a slice, already
        # sorted (respatpu takes the union with one global sort).
        nsn_ = ptr.size - 1
        first = ptr[:-1]
        lo = cstart[first] + (ptr[1:] - first - 1)  # skip the supernode's other columns
        hi = cstart[first + 1]
        return [lr[lo[s]:hi[s]] for s in range(nsn_)]

    rowstruct = snode_struct(snode_ptr)

    # relaxed amalgamation: greedily absorb the next supernode into the
    # current one when the child's columns flow directly into it and the
    # merged front grows by <= amalg explicit-zero entries (small extra dense
    # work for far fewer fronts). Single left-to-right pass, O(sum |rowstruct|).
    nsn0 = snode_ptr.size - 1
    out_starts = [int(snode_ptr[0])]
    out_rs: List[np.ndarray] = []
    cur_start, cur_end = int(snode_ptr[0]), int(snode_ptr[1])
    cur_rs = rowstruct[0]
    for s in range(1, nsn0):
        nxt_end = int(snode_ptr[s + 1])
        w_cur = cur_end - cur_start
        if cur_rs.size and cur_rs[0] == cur_end:
            union = np.union1d(cur_rs[cur_rs >= nxt_end], rowstruct[s])
            nxt_cols = np.arange(cur_end, nxt_end)
            extra = ((union.size - rowstruct[s].size) * w_cur
                     + np.setdiff1d(nxt_cols, cur_rs,
                                    assume_unique=True).size * w_cur)
            if extra <= amalg:
                cur_end, cur_rs = nxt_end, union
                continue
        out_starts.append(cur_end)
        out_rs.append(cur_rs)
        cur_start, cur_end, cur_rs = cur_end, nxt_end, rowstruct[s]
    out_rs.append(cur_rs)
    snode_ptr = np.array(out_starts + [n], dtype=np.int64)
    rowstruct = out_rs

    nsn = snode_ptr.size - 1
    col2sn = np.repeat(np.arange(nsn, dtype=np.int64), np.diff(snode_ptr))
    first_rs = np.array([rs[0] if rs.size else 0 for rs in rowstruct],
                        dtype=np.int64)
    has_rs = np.array([rs.size > 0 for rs in rowstruct])
    sn_parent = np.where(has_rs, col2sn[first_rs], -1)

    # tree-level batches (independent fronts): leaves first
    depth = np.zeros(nsn, dtype=np.int64)
    for s in range(nsn):  # parents have larger indices (postorder)
        p = sn_parent[s]
        if p >= 0:
            depth[p] = max(depth[p], depth[s] + 1)
    levels = [np.flatnonzero(depth == d) for d in range(int(depth.max()) + 1)] \
        if nsn else []

    return SupernodePartition(n=n, perm=perm, filled=filled,
                              snode_ptr=snode_ptr, sn_parent=sn_parent,
                              rowstruct=rowstruct, levels=levels,
                              fill_nnz=filled.nnz)


@dataclasses.dataclass
class MultifrontalFactor:
    """Factored supernodes: dense (L11\\U11, L21, U12) blocks per front."""

    part: SupernodePartition
    lu11: List[np.ndarray]  # [w, w] packed unit-L lower + U upper
    l21: List[np.ndarray]  # [r, w]
    u12: List[np.ndarray]  # [w, r]
    n_pivot_perturbed: int


def multifrontal_factor(a: CSRMatrix, part: Optional[SupernodePartition] = None,
                        order: str = "fillauto",
                        pivot_eps: Optional[float] = None) -> MultifrontalFactor:
    """Numeric multifrontal factorization (host oracle; PARDISO phase 22)."""
    if part is None:
        part = analyze_supernodes(a, order=order)
    n = part.n
    if pivot_eps is None:
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        pivot_eps = 1e-13 * max(amax, 1.0)
    f = part.filled  # values already scattered (permuted A)
    frows = np.repeat(np.arange(n, dtype=np.int64), f.row_lengths())
    fcols = f.indices.astype(np.int64)

    lu11: List[np.ndarray] = []
    l21: List[np.ndarray] = []
    u12: List[np.ndarray] = []
    stack: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * part.nsn
    children: List[List[int]] = [[] for _ in range(part.nsn)]
    for s in range(part.nsn):
        p = part.sn_parent[s]
        if p >= 0:
            children[p].append(s)
    nbad = 0

    for s in range(part.nsn):
        j0, j1 = part.snode_ptr[s], part.snode_ptr[s + 1]
        w = j1 - j0
        rs = part.rowstruct[s]
        idx = np.concatenate([np.arange(j0, j1), rs])
        m = idx.size
        front = np.zeros((m, m))
        pos = {int(g): t for t, g in enumerate(idx)}
        # assemble original entries: rows of the snode (cols >= j0) and
        # columns of the snode (rows > j1 handled via the symmetric pattern)
        for t, i in enumerate(range(j0, j1)):
            sl = slice(f.indptr[i], f.indptr[i + 1])
            cj = fcols[sl]
            sel = cj >= j0
            front[t, [pos[int(x)] for x in cj[sel]]] += f.data[sl][sel]
        for g in rs:
            sl = slice(f.indptr[g], f.indptr[g + 1])
            cj = fcols[sl]
            sel = (cj >= j0) & (cj < j1)
            front[pos[int(g)], [pos[int(x)] for x in cj[sel]]] += f.data[sl][sel]
        # extend-add child Schur complements
        for ch in children[s]:
            upd = stack[ch]
            if upd is None:
                continue
            cidx, schur = upd
            t = np.array([pos[int(g)] for g in cidx], dtype=np.int64)
            front[np.ix_(t, t)] += schur
            stack[ch] = None
        # dense partial LU of the leading w x w block (no pivoting,
        # perturbation like test_pardiso.c:144-148)
        for t in range(w):
            d = front[t, t]
            if abs(d) < pivot_eps:
                front[t, t] = d = pivot_eps if d >= 0 else -pivot_eps
                nbad += 1
            front[t + 1:, t] /= d
            front[t + 1:, t + 1:] -= np.outer(front[t + 1:, t],
                                              front[t, t + 1:])
        lu11.append(front[:w, :w].copy())
        l21.append(front[w:, :w].copy())
        u12.append(front[:w, w:].copy())
        if rs.size and part.sn_parent[s] >= 0:
            stack[s] = (rs, front[w:, w:].copy())
    return MultifrontalFactor(part=part, lu11=lu11, l21=l21, u12=u12,
                              n_pivot_perturbed=nbad)


def multifrontal_solve(fac: MultifrontalFactor, b: np.ndarray) -> np.ndarray:
    """Solve A x = b with the multifrontal factors (PARDISO phase 33)."""
    part = fac.part
    n = part.n
    y = np.asarray(b, np.float64)[part.perm].copy()
    # forward: L y = b (unit lower), supernodes ascending
    for s in range(part.nsn):
        j0, j1 = part.snode_ptr[s], part.snode_ptr[s + 1]
        w = j1 - j0
        lu = fac.lu11[s]
        for t in range(w):  # unit-lower solve within the snode
            y[j0 + t] -= lu[t, :t] @ y[j0:j0 + t]
        rs = part.rowstruct[s]
        if rs.size:
            y[rs] -= fac.l21[s] @ y[j0:j1]
    # backward: U x = y, supernodes descending
    for s in range(part.nsn - 1, -1, -1):
        j0, j1 = part.snode_ptr[s], part.snode_ptr[s + 1]
        w = j1 - j0
        rs = part.rowstruct[s]
        if rs.size:
            y[j0:j1] -= fac.u12[s] @ y[rs]
        lu = fac.lu11[s]
        for t in range(w - 1, -1, -1):
            y[j0 + t] = (y[j0 + t] - lu[t, t + 1:] @ y[j0 + t + 1:j1]) / lu[t, t]
    x = np.empty_like(y)
    x[part.perm] = y
    return x
