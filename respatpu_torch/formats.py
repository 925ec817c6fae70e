"""Host-side sparse matrix containers (numpy): COO, CSR and conversions.

Replaces the reference's ``CSR``/``COO`` structs and COO->CSR conversion
(ReadMatrixMarket/loadMatrixMarket.h:17-36, loadMatrixMarket.cpp:216-242).
A copy of ``respatpu.formats`` without the padded device layouts: the card
gathers in hardware, so CSR goes to the device as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["COOMatrix", "CSRMatrix", "coo_to_csr", "csr_to_coo",
           "csr_transpose"]


@dataclass
class COOMatrix:
    """Coordinate-format sparse matrix (host, numpy), 0-based indices."""

    shape: Tuple[int, int]
    row: np.ndarray  # int32[nnz]
    col: np.ndarray  # int32[nnz]
    val: np.ndarray  # float64[nnz] (canonical host precision)

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def tocsr(self) -> "CSRMatrix":
        return coo_to_csr(self)


@dataclass
class CSRMatrix:
    """Compressed-sparse-row matrix (host, numpy), canonical container.

    Column indices within each row are sorted ascending (the reference sorts
    per row too, loadMatrixMarket.cpp:237-242).
    """

    shape: Tuple[int, int]
    indptr: np.ndarray  # int64[m+1]
    indices: np.ndarray  # int32[nnz]
    data: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def tocoo(self) -> COOMatrix:
        return csr_to_coo(self)

    def toarray(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.data.dtype)
        rows = np.repeat(np.arange(m), self.row_lengths())
        out[rows, self.indices] = self.data
        return out

    def transpose(self) -> "CSRMatrix":
        return csr_transpose(self)


def coo_to_csr(a: COOMatrix, sum_duplicates: bool = True) -> CSRMatrix:
    """COO -> CSR with per-row sorted columns and summed duplicates
    (loadMatrixMarket.cpp:216-242, without the reference's symmetric
    expansion bug, SURVEY.md quirk #1)."""
    m, n = a.shape
    key = a.row.astype(np.int64) * n + a.col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    row = a.row[order]
    col = a.col[order]
    val = a.val[order]
    if sum_duplicates and len(key) > 0:
        k = key[order]
        uniq = np.empty(len(k), dtype=bool)
        uniq[0] = True
        np.not_equal(k[1:], k[:-1], out=uniq[1:])
        seg = np.cumsum(uniq) - 1
        val = np.bincount(seg, weights=val, minlength=seg[-1] + 1 if len(seg) else 0)
        row = row[uniq]
        col = col[uniq]
    counts = np.bincount(row, minlength=m)
    # int64 row pointer: respatpu narrows it to int32, which wraps past
    # 2^31 entries (ROADMAP R4)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix(
        shape=(m, n),
        indptr=indptr,
        indices=np.ascontiguousarray(col, dtype=np.int32),
        data=np.ascontiguousarray(val, dtype=np.float64),
    )


def csr_to_coo(a: CSRMatrix) -> COOMatrix:
    rows = np.repeat(np.arange(a.nrows, dtype=np.int32), a.row_lengths())
    return COOMatrix(shape=a.shape, row=rows, col=a.indices.copy(), val=a.data.copy())


def csr_transpose(a: CSRMatrix) -> CSRMatrix:
    """CSR transpose == CSC view of A, built with a counting sort
    (loadMatrixMarket.cpp:79-81, test_superLU_MT.c:85)."""
    m, n = a.shape
    coo = csr_to_coo(a)
    return coo_to_csr(COOMatrix(shape=(n, m), row=coo.col, col=coo.row, val=coo.val),
                      sum_duplicates=False)
