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
SOURCES = ("spmv_csr.cu", "band_lu.cu", "frontal.cu", "ilu0.cu", "sptrsv.cu", "splu.cu",
           "dia.cu")
HEADERS = ("common.cuh",)  # included by the sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_ENTRIES = ("respa_spmv_csr_f32", "respa_spmv_csr_f32_ftz",
            "respa_spmv_csr_bf16", "respa_spmv_csr_f64")
_BLOCK_LU = ("respa_block_lu_f32", "respa_block_lu_f32_ftz", "respa_block_lu_f64")
_BAND_SWEEP = tuple(f"respa_band_sweep_{d}_{i}" for d in ("fwd", "bwd")
                    for i in ("f32", "f32_ftz", "bf16", "f64"))
_INSTANCES = ("f32", "f32_ftz", "f64")
_EXTEND_ADD = tuple(f"respa_extend_add_{i}" for i in _INSTANCES)
_FRONT_FWD = tuple(f"respa_front_sweep_fwd_{i}" for i in _INSTANCES)
_FRONT_BWD = tuple(f"respa_front_sweep_bwd_{i}" for i in _INSTANCES)
_ROWS_REDUCE = ("respa_rows_reduce_f32", "respa_rows_reduce_f64")
_ILU_INSTANCES = ("f32", "f32_ftz", "bf16", "f64")
_ILU0_SWEEP = tuple(f"respa_ilu0_sweep_{i}" for i in _ILU_INSTANCES)
_TRI_SOLVE = tuple(f"respa_tri_solve_{d}_{i}" for d in ("lower", "upper")
                   for i in _ILU_INSTANCES)
_SPLU_FACTOR = tuple(f"respa_splu_factor_{i}" for i in _ILU_INSTANCES)
_DIA_SPMV = tuple(f"respa_dia_spmv_{i}" for i in _ILU_INSTANCES)

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise CompileError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA toolkit is needed to build the kernels")
    return path


def build(extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile (if not built yet) and bind the kernel library.

    ``extra_flags`` are added to ``NVCC_FLAGS``; the package passes none.
    ``bench/spmv_tune.py`` passes ``-D`` overrides of the kernel's
    compile-time sizes to compare them on the card.
    """
    path = build_shared("librespa_kernels.so",
                        [os.path.join(_CSRC, s) for s in SOURCES],
                        [_nvcc(), *NVCC_FLAGS, *extra_flags], per_source=True,
                        depends=[os.path.join(_CSRC, h) for h in HEADERS])
    lib = ctypes.CDLL(path)
    for name in _ENTRIES:
        fn = getattr(lib, name)
        # device, n_blocks, then row_blocks, indptr, indices, vals, x, y, stream
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    for name in _BLOCK_LU:
        fn = getattr(lib, name)
        # device, nblocks, p, in, in_is_bf16, ld, batch_stride, eps, lu, n_perturbed, stream
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BAND_SWEEP:
        fn = getattr(lib, name)
        # device, nb, p, ml, mu, then band, b, out, mail, stream
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in _EXTEND_ADD:
        fn = getattr(lib, name)
        # device, pool, g0, nfronts, wp, rp, lp, poff, pmp, seg_ptr, nseg, tiles, stream
        fn.argtypes = [i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr]
        fn.restype = ctypes.c_int
    for name in (*_FRONT_FWD, *_FRONT_BWD):
        fn = getattr(lib, name)
        # device, pool, g0, nfronts, wp, rp, piv, rsx, y, n, out, regime, tiles, ctl, mail,
        # stream
        fn.argtypes = [i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i32, ptr, i32, i32, ptr, ptr,
                       ptr]
        fn.restype = ctypes.c_int
    for name in _ROWS_REDUCE:
        fn = getattr(lib, name)
        # device, y, upd, rows, ptr, src, nd, flush, stream
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
        fn.restype = ctypes.c_int
    for name in _ILU0_SWEEP:
        fn = getattr(lib, name)
        # device, nnz, a, old, out, ptr, pairs_a, pairs_b, kind, diag_col, eps, fix, resid,
        # stream
        fn.argtypes = [i32, i64, *[ptr] * 8, ctypes.c_double, i32, ptr, ptr]
        fn.restype = ctypes.c_int
    for name in _TRI_SOLVE:
        fn = getattr(lib, name)
        # device, ntasks, warps, tasks, level_ptr, perm, ptr, cols, vals, dinv, b, y, yp, ctl,
        # nctl, mode, stream
        fn.argtypes = [i32, i32, i32, *[ptr] * 11, i32, i32, ptr]
        fn.restype = ctypes.c_int
    lib.respa_tri_solve_limit.argtypes = [i32]
    lib.respa_tri_solve_limit.restype = ctypes.c_int
    for name in _SPLU_FACTOR:
        fn = getattr(lib, name)
        # device, ntasks, warps, tasks, level_ptr, perm, ptr, pairs_a, pairs_b, is_lower,
        # diag_col, a, vals, eps, ctl, nctl, stream
        fn.argtypes = [i32, i32, i32, *[ptr] * 10, ctypes.c_double, ptr, i32, ptr]
        fn.restype = ctypes.c_int
    lib.respa_splu_limit.argtypes = [i32]
    lib.respa_splu_limit.restype = ctypes.c_int
    for name in _DIA_SPMV:
        fn = getattr(lib, name)
        # device, n, ncols, ndiag, offsets, diags, x, tile, then the remainder's tile_ptr,
        # rows, ptr, cols, vals, and y, stream
        fn.argtypes = [i32, i64, i64, i32, *[ptr] * 3, i32, *[ptr] * 7]
        fn.restype = ctypes.c_int
    # device, rounds, flag, out, stream
    lib.respa_link_probe.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.respa_link_probe.restype = ctypes.c_int
    for name in ("respa_spmv_csr_cap", "respa_spmv_csr_max_rows", "respa_band_max_p",
                 "respa_front_max_tri"):
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
