"""Corpus sweep runner: the dual-precision SpMV sweep (bench_spmv.cc and
run_*.sh equivalents; the counterpart of ``respatpu.bench.runner``).

Rows follow respatpu's schema, which follows test_spmv.c:51-219
(threads,matrix,t64,t32,err,date). Synthetic stand-ins are flagged in the
row, and the append-mode CSV keeps sweeps resumable (test_spmv.c:50). The
ILU(0) and LU sweeps are ported with their solvers in later slices.
"""
from __future__ import annotations

import csv
import os
from datetime import datetime, timezone
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import corpus
from .. import solve as slv
from ..precision import downcast_check, get_policy

__all__ = ["sweep_spmv", "SPMV_HEADER"]

SPMV_HEADER = ["policy_hi", "policy_lo", "chips", "matrix", "n", "nnz",
               "synthetic", "t_hi_s", "t_lo_s", "t_lo_min_s", "t_lo_std_s",
               "mean_abs_err", "n_overflow", "timestamp"]


def _ts() -> str:
    return datetime.now(timezone.utc).isoformat(timespec="seconds")


def _append(path: Optional[str], header: Sequence[str], row: Sequence):
    if path is None:
        return
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)


def sweep_spmv(names: Sequence[str], csv_path: Optional[str] = None,
               policies=("fp64", "fp32"), reps: int = 5,
               max_synth_nnz: Optional[int] = 70_000_000, verbose: bool = True,
               device: Union[str, torch.device] = "cuda"):
    """Dual-precision SpMV sweep (test_spmv.c protocol): per matrix, time the
    high- and low-precision SpMVs on ``device`` and report their mean
    absolute difference.

    ``t_hi_s`` and ``t_lo_s`` are medians over ``reps`` timed SpMVs, each
    past the plausibility gate. Returns one dict per matrix with the CSV
    row's fields, plus ``timing_hi`` and ``timing_lo`` (the
    :class:`~respatpu_torch.timing.OpTiming` of each policy)."""
    out = []
    for name in names:
        a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
        rng = np.random.default_rng(42)
        x = rng.standard_normal(a.shape[1])  # LAPACKE_dlarnv analogue
        y_hi, t_hi = slv.spmv_timed(a, x, policies[0], device=device, reps=reps)
        y_lo, t_lo = slv.spmv_timed(a, x, policies[1], device=device, reps=reps)
        err = float(np.abs(slv._to_host_f64(y_hi) - slv._to_host_f64(y_lo)).mean())
        # overflow-guarded downcast accounting (corrected test_spmv.c:109-145)
        n_over = 0
        if get_policy(policies[1]).dtype != torch.float64:
            _, n_over = downcast_check(a.data)
        row = [policies[0], policies[1], 1, name, a.shape[0], a.nnz, int(synth),
               f"{t_hi.median:.6e}", f"{t_lo.median:.6e}", f"{t_lo.min:.6e}",
               f"{t_lo.std:.2e}", f"{err:.3e}", n_over, _ts()]
        _append(csv_path, SPMV_HEADER, row)
        out.append(dict(zip(SPMV_HEADER, row), timing_hi=t_hi, timing_lo=t_lo))
        if verbose:
            print(f"[spmv] {name}: t_{policies[0]}={t_hi.median*1e6:.2f}us "
                  f"t_{policies[1]}={t_lo.median*1e6:.2f}us err={err:.2e}"
                  f"{' (synthetic)' if synth else ''}")
    return out
