"""SpMV front end and the verification idioms (SURVEY.md §4).

The counterpart of ``respatpu/solve.py:100-174``. The direct solvers, the
ILU(0) preconditioner and the Krylov loops are ported in later slices.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .formats import CSRMatrix
from .kernels.spmv import spmv, to_device
from .precision import Policy, get_policy
from .timing import (OpTiming, check_plausible, device_bandwidth,
                     spmv_csr_sol_bytes, time_op)

__all__ = ["spmv_timed", "relative_residual", "inf_norm_error",
           "make_rhs_for_known_x"]

WARMUP = 3  # untimed SpMVs before the timed repetitions


def _to_host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def relative_residual(a: CSRMatrix, x, b) -> float:
    """||A x - b||_2 / ||b||_2 computed in host fp64 with an independent SpMV
    (the test_pardiso.c:258-275 gate)."""
    xh = _to_host_f64(x)
    bh = _to_host_f64(b)
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    ax = np.zeros(a.nrows)
    np.add.at(ax, rows, a.data * xh[a.indices])
    r = ax - bh
    nb = np.linalg.norm(bh)
    return float(np.linalg.norm(r) / (nb if nb > 0 else 1.0))


def inf_norm_error(x, x_true: np.ndarray) -> float:
    """Relative infinity-norm error vs known solution
    (dinf_norm_error equivalent, test_superILU.c:128-133)."""
    xh = _to_host_f64(x)
    scale = np.abs(x_true).max()
    return float(np.abs(xh - x_true).max() / (scale if scale > 0 else 1.0))


def make_rhs_for_known_x(a: CSRMatrix, x_true: Optional[np.ndarray] = None):
    """b = A x_true for a known solution (GenXtrue/FillRHS equivalent,
    test_superLU_MT.c:118-132). Default x_true = all ones."""
    if x_true is None:
        x_true = np.ones(a.ncols)
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    b = np.zeros(a.nrows)
    np.add.at(b, rows, a.data * x_true[a.indices])
    return b, x_true


def spmv_timed(a: CSRMatrix, x: np.ndarray, policy: Union[str, Policy] = "fp32",
               device: Union[str, torch.device] = "cuda", reps: int = 5,
               fmt: str = "auto"):
    """SpMV result and its timing (test_spmv.c:168-180 protocol).

    Uploads ``a`` under ``policy`` and x (host fp64) in the policy's x type,
    computes y once, then times ``WARMUP`` untimed and ``reps`` timed SpMVs
    with :func:`respatpu_torch.timing.time_op`. The timing must pass the
    plausibility gate against the CSR byte model at the device's measured
    copy bandwidth (probed once per device), or this raises. Returns
    ``(y, OpTiming)``; y stays on ``device``.
    """
    policy = get_policy(policy)
    dev = to_device(a, policy, device, fmt=fmt)
    xd = torch.from_numpy(np.asarray(x, np.float64)).to(policy.accum_dtype).to(dev.device)
    y = spmv(dev, xd)
    t: OpTiming = time_op(lambda: spmv(dev, xd), dev.device, warmup=WARMUP, reps=reps)
    m, n = a.shape
    nbytes = spmv_csr_sol_bytes(m, n, a.nnz, dev.vals.element_size(), xd.element_size())
    check_plausible(t, nbytes, device_bandwidth(dev.device))
    return y, t
