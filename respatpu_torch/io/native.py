"""ctypes bindings for the port's native host library: the Matrix Market
parser (``io/csrc/mtx_parse.cpp``: the header and the coordinate-entry
parsers) and the reverse Cuthill-McKee ordering (``io/csrc/rcm_order.cpp``).

The sources are the port's own. They are compiled at first use with the host C++
compiler into the checkout's ``build/`` directory
(``respatpu_torch._buildlib``) and loaded from there. When no C++ compiler
is present the callers fall back to the numpy parser and the Python
breadth-first search (host work; nothing on the device depends on it).
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
_SOURCES = (_SOURCE, os.path.join(_CSRC, "rcm_order.cpp"))
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
