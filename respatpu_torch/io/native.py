"""ctypes bindings for respatpu's native host library (``librespa_host.so``):
the Matrix Market header and entry parsers only.

The C++ source stays in ``respatpu/io/_native`` and is shared, not forked:
the library is loaded from there by path and built with its Makefile when it
is missing. When no C++ toolchain is present the caller falls back to the
numpy parser (host parsing; nothing on the device depends on it).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "respatpu", "io", "_native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librespa_host.so")

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


def _build() -> bool:
    if not os.path.exists(os.path.join(_NATIVE_DIR, "host_ops.cpp")):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_SO_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO_PATH) and not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(_SO_PATH)
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
