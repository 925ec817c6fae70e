"""respatpu_torch: mixed-precision sparse linear algebra on PyTorch and CUDA.

The port of ``respatpu`` (JAX/Pallas on a TPU) to one NVIDIA H100. ``respatpu``
stays beside it as the reference the port is tested against. This package
imports ``torch`` and never ``jax``.

Ported so far: the dual-precision SpMV path (Matrix Market or corpus
stand-in input, upload under a precision policy, a hand-written CUDA CSR
SpMV kernel in fp32, fp32+FTZ, bf16-value and fp64 instances, the
cross-precision error, timed sweeps). See ROADMAP.md for the order of the
rest.
"""
from . import formats, precision
from .formats import COOMatrix, CSRMatrix, coo_to_csr
from .precision import (BF16, FP32, FP32_FTZ, FP64, Policy, downcast_check,
                        ftz, get_policy)

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("solve", "timing", "kernels", "bench", "io", "interop", "cli"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'respatpu_torch' has no attribute {name!r}")


__all__ = [
    "COOMatrix", "CSRMatrix", "coo_to_csr",
    "FP32", "FP32_FTZ", "BF16", "FP64", "Policy", "get_policy",
    "downcast_check", "ftz", "formats", "precision",
    "solve", "timing", "kernels", "bench", "io", "interop", "cli",
]
