"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc`` are compiled at first use with ``nvcc``
into a shared library with a plain C interface, loaded with ctypes
(``respatpu_torch._buildlib`` says where it goes). A missing or failing
``nvcc`` raises with its stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Sequence

from .._buildlib import CompileError, build_shared

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("spmv_csr.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_ENTRIES = ("respa_spmv_csr_f32", "respa_spmv_csr_f32_ftz",
            "respa_spmv_csr_bf16", "respa_spmv_csr_f64")

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise CompileError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA toolkit is needed to build the SpMV kernel")
    return path


def build(extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile (if not built yet) and bind the kernel library.

    ``extra_flags`` are added to ``NVCC_FLAGS``; the package passes none.
    ``bench/spmv_tune.py`` passes ``-D`` overrides of the kernel's
    compile-time sizes to compare them on the card.
    """
    path = build_shared("librespa_kernels.so",
                        [os.path.join(_CSRC, s) for s in SOURCES],
                        [_nvcc(), *NVCC_FLAGS, *extra_flags])
    lib = ctypes.CDLL(path)
    for name in _ENTRIES:
        fn = getattr(lib, name)
        # device, n_blocks, then row_blocks, indptr, indices, vals, x, y, stream
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    for name in ("respa_spmv_csr_cap", "respa_spmv_csr_max_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build()
        return _lib
