"""ctypes bindings for the port's native Matrix Market parser
(``io/csrc/mtx_parse.cpp``): the header and the coordinate-entry parsers.

The source is the port's own. It is compiled at first use with the host C++
compiler into the checkout's ``build/`` directory
(``respatpu_torch._buildlib``) and loaded from there. When no C++ compiler
is present the caller falls back to the numpy parser (host parsing; nothing
on the device depends on it).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from .._buildlib import CompileError, build_shared

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mtx_parse.cpp")
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()
_build_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
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
        return build_shared("librespa_mtx.so", [_SOURCE], [cxx, *_CXX_FLAGS])
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
