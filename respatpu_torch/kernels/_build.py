"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc`` are compiled at first use with ``nvcc``
into a shared library with a plain C interface, loaded with ctypes. The
library goes to ``build/respatpu_torch/<key>/`` at the root of the checkout,
where ``<key>`` hashes the sources and the flags, so an edit to either gives
a new build. A missing or failing ``nvcc`` raises with its stderr: there is
no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                           "respatpu_torch")
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
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA toolkit is needed to build the SpMV kernel")
    return path


def _key() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_BUILD_ROOT, _key(), "librespa_kernels.so")


def _compile(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(_CSRC, s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name in _ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 6
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
