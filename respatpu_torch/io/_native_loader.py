"""Native-parser-backed Matrix Market loading (fast path for load_csr)."""
from __future__ import annotations

import numpy as np

from . import native
from .mtx import _expand_symmetry
from ..formats import COOMatrix, CSRMatrix, coo_to_csr

_SYM_NAMES = {0: "general", 1: "symmetric", 2: "skew-symmetric", 3: "hermitian"}


def available() -> bool:
    return native.available()


def load_coo(path: str, transpose: bool = False, dtype=np.float64) -> COOMatrix:
    info, row, col, val = native.mtx_parse(path)
    row = row.astype(np.int64)
    col = col.astype(np.int64)
    base = 1
    if info.nnz and (row.min() == 0 or col.min() == 0):
        base = 0
    row -= base
    col -= base
    row, col, val = _expand_symmetry(row, col, val, _SYM_NAMES[info.symmetry])
    m, n = int(info.nrows), int(info.ncols)
    coo = COOMatrix((m, n), row.astype(np.int32), col.astype(np.int32),
                    val.astype(dtype))
    if transpose:
        coo = COOMatrix((n, m), coo.col, coo.row, coo.val)
    return coo


def load_csr(path: str, transpose: bool = False, dtype=np.float64) -> CSRMatrix:
    return coo_to_csr(load_coo(path, transpose=transpose, dtype=dtype))
