"""respatpu_torch: mixed-precision sparse linear algebra on PyTorch and CUDA.

The port of ``respatpu`` (JAX/Pallas on a TPU) to one NVIDIA H100. ``respatpu``
stays beside it as the reference the port is tested against. This package
imports ``torch`` and never ``jax``.

Ported so far: the dual-precision SpMV path (Matrix Market or corpus
stand-in input, upload under a precision policy, a hand-written CUDA CSR
SpMV kernel in fp32, fp32+FTZ, bf16-value and fp64 instances, the
cross-precision error, timed sweeps), and the direct-solve path (RCM
ordering, blocked band LU with two hand-written CUDA kernels for its
dependent chains, ``factorize(method="auto")``, mixed-precision iterative
refinement with fp64 residuals and the GMRES-IR fallback), the multifrontal
LU with GESP matching, and the ILU(0) path (Chow-Patel sweeps and one-launch
triangular solves, two hand-written CUDA kernels, with the Jacobi and ISAI
applies and the CG, GMRES and BiCGSTAB solvers), the scheduled sparse LU and
the DIA stencil SpMV, factor persistence (``persist``), the experiment
config (``config``) and the precision study (``bench.study``), and the
distributed stack on a mesh of shards, in one process or over the ranks of
a process group (``dist``: ``init_distributed``, the row-partitioned SpMV,
block-Jacobi ILU(0), CG and BiCGSTAB; ``dist_lu``: SPIKE; ``dist_snlu_sub``:
the subtree-sharded multifrontal LU). See ROADMAP.md for the rest.
"""
from . import formats, precision
from .formats import COOMatrix, CSRMatrix, coo_to_csr
from .precision import (BF16, FP32, FP32_FTZ, FP64, Policy, downcast_check,
                        ftz, get_policy)

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("solve", "timing", "kernels", "bench", "io", "interop", "cli",
                "analysis", "persist", "config", "dist", "dist_lu", "dist_snlu_sub"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'respatpu_torch' has no attribute {name!r}")


__all__ = [
    "COOMatrix", "CSRMatrix", "coo_to_csr",
    "FP32", "FP32_FTZ", "BF16", "FP64", "Policy", "get_policy",
    "downcast_check", "ftz", "formats", "precision",
    "solve", "timing", "kernels", "bench", "io", "interop", "cli", "analysis",
    "persist", "config", "dist", "dist_lu", "dist_snlu_sub",
]
