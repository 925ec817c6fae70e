"""ctypes bindings for the port's native host library: the Matrix Market
parser (``io/csrc/mtx_parse.cpp``: the header and the coordinate-entry
parsers), the reverse Cuthill-McKee ordering (``io/csrc/rcm_order.cpp``) and
what the multifrontal analysis needs: the symmetric symbolic fill
(``io/csrc/symbolic_fill.cpp``), the weighted-matching assignment
(``io/csrc/sparse_assignment.cpp``), the fill-reducing orderings
(``io/csrc/fill_order.cpp``: approximate minimum degree, nested dissection)
and the front pool's assembly map (``io/csrc/frontal_assembly.cpp``); and the
ILU(0) path's schedules (``io/csrc/ilu_schedule.cpp``: the level of every row
of a triangular solve, the Chow-Patel pair lists).

The sources are the port's own. They are compiled at first use with the host C++
compiler into the checkout's ``build/`` directory
(``respatpu_torch._buildlib``) and loaded from there. When no C++ compiler
is present the callers fall back to the numpy parser, the Python
breadth-first search, the row-merge symbolic fill, scipy's matching, a
naive minimum degree, array operations for the assembly map and Python loops
for the ILU schedules (host work; nothing on the device depends on it).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from .._buildlib import CompileError, build_shared

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCE = os.path.join(_CSRC, "mtx_parse.cpp")
_SOURCES = (_SOURCE, *(os.path.join(_CSRC, f) for f in (
    "rcm_order.cpp", "symbolic_fill.cpp", "sparse_assignment.cpp", "fill_order.cpp",
    "frontal_assembly.cpp", "ilu_schedule.cpp")))
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()
_build_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


class _MtxInfo(ctypes.Structure):
    _fields_ = [("nrows", ctypes.c_int64), ("ncols", ctypes.c_int64),
                ("nnz", ctypes.c_int64), ("field", ctypes.c_int32),
                ("symmetry", ctypes.c_int32), ("fmt", ctypes.c_int32),
                ("data_offset", ctypes.c_int64)]


def _build() -> Optional[str]:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        return None
    try:
        return build_shared("librespa_host.so", list(_SOURCES), [cxx, *_CXX_FLAGS])
    except CompileError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.mtx_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MtxInfo)]
        lib.mtx_read_header.restype = ctypes.c_int
        lib.mtx_parse_entries.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int32,
                                          _i32p, _i32p, _f64p, ctypes.c_int32]
        lib.mtx_parse_entries.restype = ctypes.c_int64
        lib.rcm_order_csr.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p]
        lib.rcm_order_csr.restype = ctypes.c_int
        lib.symbolic_fill_sym_compute.argtypes = [ctypes.c_int64, _i64p, _i32p]
        lib.symbolic_fill_sym_compute.restype = ctypes.c_int64
        lib.symbolic_fill_fetch.argtypes = [ctypes.c_int64, _i64p, _i32p]
        lib.symbolic_fill_fetch.restype = ctypes.c_int
        lib.sparse_assignment.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p, _i32p]
        lib.sparse_assignment.restype = ctypes.c_int
        lib.amd_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p, ctypes.c_double]
        lib.amd_order.restype = ctypes.c_int
        lib.nd_order.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p, ctypes.c_int32]
        lib.nd_order.restype = ctypes.c_int
        lib.frontal_asm_dst.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i32p,
                                        _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p]
        lib.frontal_asm_dst.restype = ctypes.c_int
        lib.level_schedule.argtypes = [ctypes.c_int64, _i64p, _i32p, ctypes.c_int32, _i32p]
        lib.level_schedule.restype = ctypes.c_int
        lib.cp_schedule_count.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p, _i32p, _i32p,
                                          ctypes.c_int32]
        lib.cp_schedule_count.restype = ctypes.c_int64
        lib.cp_schedule_fill.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p, _i32p, _i64p,
                                         _i64p, _i64p, _i64p, ctypes.c_int32]
        lib.cp_schedule_fill.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def mtx_header(path: str):
    lib = _load()
    info = _MtxInfo()
    rc = lib.mtx_read_header(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"native mtx header parse failed ({rc}) for {path}")
    return info


def mtx_parse(path: str, nthreads: int = 0):
    """Parse coordinate entries -> (info, row, col, val), indices as stored."""
    lib = _load()
    info = mtx_header(path)
    if info.fmt != 0:
        raise ValueError("native parser handles coordinate format only")
    nnz = info.nnz
    if info.field == 3:  # complex typecode (mm_io.h:49-89 parity)
        import warnings
        warnings.warn(
            "complex Matrix Market file: imaginary parts are DROPPED "
            "(real-part load)", UserWarning, stacklevel=2)
    row = np.empty(nnz, dtype=np.int32)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    got = lib.mtx_parse_entries(path.encode(), info.data_offset, nnz, info.field,
                                row.ctypes.data_as(_i32p), col.ctypes.data_as(_i32p),
                                val.ctypes.data_as(_f64p), nthreads)
    if got < nnz:
        raise ValueError(f"native mtx parse failed ({got}) for {path}")
    return info, row, col, val


def rcm(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee order of an n x n matrix given by its CSR
    pattern (int64 row pointer, int32 columns); the routine symmetrizes it
    and drops the diagonal itself."""
    lib = _load()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if indptr.shape != (n + 1,) or indices.shape != (int(indptr[-1]),):
        raise ValueError("rcm: indptr and indices do not describe n rows")
    order = np.empty(n, dtype=np.int32)
    rc = lib.rcm_order_csr(n, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                           order.ctypes.data_as(_i32p))
    if rc != 0:
        raise ValueError(f"rcm: a column index is out of range ({rc})")
    return order


def _pattern(n: int, indptr: np.ndarray, indices: np.ndarray, what: str):
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if indptr.shape != (n + 1,) or indices.shape != (int(indptr[-1]),):
        raise ValueError(f"{what}: indptr and indices do not describe n rows")
    return indptr, indices


def symbolic_fill(n: int, indptr: np.ndarray, indices: np.ndarray):
    """Filled pattern of the unpivoted LU of a structurally SYMMETRIC pattern
    (the caller checks or symmetrizes), by the elimination tree: returns
    ``(fill_indptr int64[n+1], fill_indices int32[fnnz])``, columns ascending
    in each row."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "symbolic_fill")
    with _lock:  # the library keeps one result between compute and fetch
        fnnz = lib.symbolic_fill_sym_compute(n, indptr.ctypes.data_as(_i64p),
                                             indices.ctypes.data_as(_i32p))
        if fnnz < 0:
            raise RuntimeError("symbolic fill failed")
        if fnnz * 4 > 32 << 30:
            # a refusal with its size in the message, never a raw allocator
            # error: no numeric phase could hold a factor this dense anyway
            raise MemoryError(
                f"symbolic fill has {fnnz/1e9:.2f}G entries "
                f"({fnnz * 4 / 2**30:.0f} GiB of indices); the ordering "
                "does not control fill on this pattern")
        out_ptr = np.empty(n + 1, dtype=np.int64)
        out_idx = np.empty(fnnz, dtype=np.int32)
        lib.symbolic_fill_fetch(n, out_ptr.ctypes.data_as(_i64p),
                                out_idx.ctypes.data_as(_i32p))
    return out_ptr, out_idx


def sparse_assignment(n: int, indptr: np.ndarray, indices: np.ndarray,
                      cost: np.ndarray) -> Optional[np.ndarray]:
    """Min-cost perfect bipartite matching (MC64 slot). Returns
    ``match[i] = column of row i`` or None when structurally singular."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "sparse_assignment")
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    if cost.shape != indices.shape:
        raise ValueError("sparse_assignment: one cost an entry")
    out = np.empty(n, dtype=np.int32)
    rc = lib.sparse_assignment(n, indptr.ctypes.data_as(_i64p),
                               indices.ctypes.data_as(_i32p),
                               cost.ctypes.data_as(_f64p), out.ctypes.data_as(_i32p))
    return out if rc == 0 else None


def amd(n: int, indptr: np.ndarray, indices: np.ndarray,
        dense_alpha: float = 10.0) -> np.ndarray:
    """Approximate minimum degree (quotient graph) on a SYMMETRIC pattern."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "amd")
    out = np.empty(n, dtype=np.int32)
    rc = lib.amd_order(n, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                       out.ctypes.data_as(_i32p), dense_alpha)
    if rc != 0:
        raise RuntimeError("amd_order failed (incomplete elimination)")
    return out


def nd(n: int, indptr: np.ndarray, indices: np.ndarray,
       leaf_size: int = 256) -> np.ndarray:
    """Nested dissection (level separators, AMD leaves) on a SYMMETRIC
    pattern: the METIS slot for large 3-D meshes."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "nd")
    out = np.empty(n, dtype=np.int32)
    rc = lib.nd_order(n, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                      out.ctypes.data_as(_i32p), leaf_size)
    if rc != 0:
        raise RuntimeError("nd_order failed (incomplete ordering)")
    return out


def frontal_asm_dst(n: int, indptr: np.ndarray, indices: np.ndarray, snode_ptr: np.ndarray,
                    rs_ptr: np.ndarray, rs: np.ndarray, off: np.ndarray, wp: np.ndarray,
                    mp: np.ndarray) -> np.ndarray:
    """Flat front-pool position of every entry of the filled pattern
    (``indptr``, ``indices``), given the supernode column ranges, the
    concatenated row structures (``rs_ptr``, ``rs``), and each front's pool
    offset, padded pivot width and size. Raises if an entry falls outside its
    front's row structure."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "frontal_asm_dst")
    nsn = int(snode_ptr.size) - 1
    arrs = [np.ascontiguousarray(v, np.int64) for v in (snode_ptr, rs_ptr, rs, off, wp, mp)]
    if arrs[1].shape != (nsn + 1,) or any(v.shape != (nsn,) for v in arrs[3:]):
        raise ValueError("frontal_asm_dst: the per-front arrays do not match snode_ptr")
    out = np.empty(indices.size, dtype=np.int64)
    rc = lib.frontal_asm_dst(n, nsn, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                             *(v.ctypes.data_as(_i64p) for v in arrs),
                             out.ctypes.data_as(_i64p))
    if rc != 0:
        raise AssertionError("filled pattern is not structurally symmetric: an entry "
                             "falls outside its front's row structure")
    return out


def level_schedule(n: int, indptr: np.ndarray, indices: np.ndarray, lower: bool) -> np.ndarray:
    """Level of every row of a triangular solve (int32[n]); see
    ``analysis.level_schedule``."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "level_schedule")
    out = np.zeros(n, dtype=np.int32)
    lib.level_schedule(n, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                       1 if lower else 0, out.ctypes.data_as(_i32p))
    return out


def cp_schedule(n: int, indptr: np.ndarray, indices: np.ndarray, col_ptr: np.ndarray,
                col_rows: np.ndarray, col_pos: np.ndarray, nthreads: int = 0,
                max_pair_bytes: int = 8 << 30):
    """Chow-Patel pair lists, ragged: ``(ptr int64[nnz+1], pairs_a, pairs_b
    int64[ptr[-1]], t_max)``, entry p's pairs at ``ptr[p] : ptr[p+1]`` in the
    order k ascending. The CSC arrays give each column's rows ascending
    (``col_ptr``, ``col_rows``) and their positions in the CSR (``col_pos``).

    Raises MemoryError, before allocating, when the lists would exceed
    ``max_pair_bytes``."""
    lib = _load()
    indptr, indices = _pattern(n, indptr, indices, "cp_schedule")
    col_ptr = np.ascontiguousarray(col_ptr, np.int64)
    col_rows = np.ascontiguousarray(col_rows, np.int32)
    col_pos = np.ascontiguousarray(col_pos, np.int64)
    nnz = int(indptr[-1])
    tcount = np.zeros(nnz, dtype=np.int32)
    t_max = lib.cp_schedule_count(n, indptr.ctypes.data_as(_i64p),
                                  indices.ctypes.data_as(_i32p), col_ptr.ctypes.data_as(_i64p),
                                  col_rows.ctypes.data_as(_i32p), tcount.ctypes.data_as(_i32p),
                                  nthreads)
    ptr = np.zeros(nnz + 1, dtype=np.int64)
    np.cumsum(tcount, out=ptr[1:])
    need = 2 * int(ptr[-1]) * 8
    if need > max_pair_bytes:
        raise MemoryError(f"schedule pair lists would need {need / 2**30:.1f} GiB "
                          f"(nnz={nnz}, {int(ptr[-1])} pairs, t_max={int(t_max)})")
    pairs_a = np.empty(int(ptr[-1]), dtype=np.int64)
    pairs_b = np.empty(int(ptr[-1]), dtype=np.int64)
    lib.cp_schedule_fill(n, indptr.ctypes.data_as(_i64p), indices.ctypes.data_as(_i32p),
                         col_ptr.ctypes.data_as(_i64p), col_rows.ctypes.data_as(_i32p),
                         col_pos.ctypes.data_as(_i64p), ptr.ctypes.data_as(_i64p),
                         pairs_a.ctypes.data_as(_i64p), pairs_b.ctypes.data_as(_i64p),
                         nthreads)
    return ptr, pairs_a, pairs_b, int(t_max)
