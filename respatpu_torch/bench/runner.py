"""Corpus sweep runner: the dual-precision SpMV sweep (bench_spmv.cc and
run_*.sh equivalents; the counterpart of ``respatpu.bench.runner``).

Rows follow respatpu's schema, which follows test_spmv.c:51-219
(threads,matrix,t64,t32,err,date). Synthetic stand-ins are flagged in the
row, and the append-mode CSV keeps sweeps resumable (test_spmv.c:50).
``sweep_lu`` is the direct LU sweep with optional fp64 refinement
(test_pardiso.c / run_pardiso.sh protocol); ``sweep_ilu0`` the ILU(0)
factorization, one timed apply and a preconditioned GMRES refined on the host
(GPU/run_ilu0.sh protocol). The distributed ILU sweep is ported with the
distributed stack.
"""
from __future__ import annotations

import csv
import os
import time
from datetime import datetime, timezone
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import corpus
from .. import solve as slv
from ..precision import downcast_check, get_policy

__all__ = ["sweep_spmv", "sweep_lu", "sweep_ilu0", "SPMV_HEADER", "LU_HEADER",
           "ILU0_HEADER"]

SPMV_HEADER = ["policy_hi", "policy_lo", "chips", "matrix", "n", "nnz",
               "synthetic", "t_hi_s", "t_lo_s", "t_lo_min_s", "t_lo_std_s",
               "mean_abs_err", "n_overflow", "timestamp"]


LU_HEADER = ["policy", "matrix", "n", "nnz", "synthetic", "method",
             "t_analyze_s", "t_factor_s", "t_factor_warm_s", "t_solve_s",
             "iterations", "rel_residual", "pivots_perturbed", "status",
             "timestamp"]


ILU0_HEADER = ["policy", "matrix", "n", "nnz", "synthetic", "t_analyze_s",
               "t_factor_s", "t_apply_s", "cp_residual", "pivots_perturbed",
               "t_krylov_s", "krylov_iters", "krylov_residual", "status",
               "timestamp"]


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


def sweep_lu(names: Sequence[str], csv_path: Optional[str] = None,
             policy="fp32", refine: bool = True, method: str = "auto",
             matching="auto", max_synth_nnz: Optional[int] = 8_000_000,
             max_band_bytes: int = 4 << 30, verbose: bool = True,
             device: Union[str, torch.device] = "cuda"):
    """Direct LU factorize+solve sweep with optional fp64 refinement
    (test_pardiso.c / run_pardiso.sh protocol).

    Routes through ``solve.factorize``'s auto chain: band LU when the band
    fits ``max_band_bytes``, else the multifrontal LU (with GESP matching on
    structurally unsymmetric patterns), else the scheduled sparse LU; a
    matrix that all three refuse gets an ``infeasible`` row that names each
    refusal. The method that served each row is recorded in the ``method``
    column (``method=band``, ``method=snlu,...`` or ``method=sparse,...``);
    ``t_factor_s`` is the first factorization, ``t_factor_warm_s`` a second
    one (PARDISO phase 22 is reported warm by the reference protocol too,
    run_pardiso.sh 11-rep loop)."""
    out = []
    for name in names:
        a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
        b, _ = slv.make_rhs_for_known_x(a)
        used = ""
        t_warm = float("nan")
        try:
            fac = slv.factorize(a, policy=policy, method=method,
                                matching=matching,
                                max_band_bytes=max_band_bytes, device=device)
            used = fac.report.notes
            t_warm = fac.refactorize_timed()
            if refine:
                _, rep = slv.solve_refined(a, b, fac=fac)
            else:
                fac.solve(b)
                rep = fac.report
            # status gates on convergence, not mere completion: a refined
            # solve that stagnated above the 1e-10 reference gate must not
            # read "ok" (the SuperLU_MT test program alarms at exactly this
            # threshold, test_superLU_MT.c:230-234)
            status = "ok" if rep.converged else "stagnated"
        except MemoryError as e:
            rep = slv.SolveReport(policy=get_policy(policy).name, notes=str(e))
            status = "infeasible"
            used = str(e)[:120]  # surface the binding ceiling in the row
        except Exception as e:  # a sweep must report, not abort (run_*.sh)
            rep = slv.SolveReport(policy=get_policy(policy).name,
                                  notes=f"{type(e).__name__}: {e}")
            status = "error"
            used = f"{type(e).__name__}: {e}"[:120]
        row = [rep.policy, name, a.shape[0], a.nnz, int(synth), used,
               f"{rep.t_analyze:.4f}", f"{rep.t_factorize:.4f}",
               f"{t_warm:.4f}", f"{rep.t_solve:.4f}", rep.iterations,
               f"{rep.residual:.3e}", rep.n_pivot_perturbed, status, _ts()]
        _append(csv_path, LU_HEADER, row)
        out.append(dict(zip(LU_HEADER, row)))
        if verbose:
            print(f"[lu] {name}: {status} [{used}] "
                  f"factor={rep.t_factorize:.3f}s "
                  f"resid={rep.residual:.2e}{' (synthetic)' if synth else ''}")
    return out


def _krylov_ir(solve_once, a, b, tol: float = 1e-10, rounds: int = 5):
    """Host-level iterative refinement around an inner Krylov solve: the
    inner solver converges to its (fp32) limit; fp64 host residuals push the
    composite to the reference 1e-10 gate when the preconditioner is strong
    enough. Returns (x, residual, total_inner_iters)."""
    bb = np.asarray(b, np.float64)
    nb = np.linalg.norm(bb)
    nb = nb if nb > 0 else 1.0
    x = np.zeros_like(bb)
    total = 0
    resid = float("inf")
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    for _ in range(rounds):
        ax = np.zeros(a.nrows)
        np.add.at(ax, rows, a.data * x[a.indices])
        r = bb - ax
        resid = float(np.linalg.norm(r)) / nb
        if resid <= tol:
            break
        d, iters = solve_once(r)
        total += iters
        x = x + d
    return x, resid, total


def sweep_ilu0(names: Sequence[str], csv_path: Optional[str] = None,
               policy="fp32", sweeps: int = 8,
               max_synth_nnz: Optional[int] = 10_000_000,
               krylov_gate: float = 1e-10, verbose: bool = True,
               device: Union[str, torch.device] = "cuda", method: str = "chow_patel"):
    """ILU(0) factorization + preconditioner apply, phase-timed
    (GPU/run_ilu0.sh protocol), plus an ILU-preconditioned GMRES(40) driven
    through fp64 host-residual refinement to the reference 1e-10 gate
    (BASELINE.json target #2; test_superILU.c:117-133 capability).

    The factorization is ``solve.Ilu0Preconditioner`` with ``method``
    (Chow-Patel sweeps by default, or "scheduled": exact ILU(0), no sweeps)
    and its default applies (Jacobi for single-word policies, the exact
    solves for fp64); ``cp_residual`` then holds its notes. ``t_apply_s`` is one apply after a warm one, ended by a
    device synchronize; the Krylov phase is ended by the host's copy of x.
    Status is ``ok`` at the gate, else ``stagnated``; a preconditioner
    refused for lack of memory gives an ``infeasible`` row. Returns one dict
    per matrix with the CSV row's fields."""
    device = torch.device(device)
    pol = get_policy(policy)
    out = []
    for name in names:
        a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
        try:
            pre = slv.Ilu0Preconditioner(a, policy=pol, sweeps=sweeps, method=method,
                                         device=device)
        except MemoryError as e:
            row = [pol.name, name, a.shape[0], a.nnz, int(synth), "", "", "",
                   str(e)[:120], 0, "", 0, "", "infeasible", _ts()]
            _append(csv_path, ILU0_HEADER, row)
            out.append(dict(zip(ILU0_HEADER, row)))
            continue
        rng = np.random.default_rng(0)
        b = rng.standard_normal(a.shape[0])
        bd = torch.from_numpy(b).to(pol.accum_dtype).to(device)
        pre.apply(bd)  # warm
        slv._sync(device)
        t0 = time.perf_counter()
        z = pre.apply(bd)
        slv._sync(device)
        t_apply = time.perf_counter() - t0
        del z

        # preconditioned Krylov + fp64-residual refinement to the gate
        t0 = time.perf_counter()

        def inner(r):
            xk, rep = slv.gmres(a, r, precond=pre, tol=1e-7)
            return xk, rep.iterations

        bk, _ = slv.make_rhs_for_known_x(a)
        xk, kres, kiters = _krylov_ir(inner, a, bk, tol=krylov_gate)
        t_krylov = time.perf_counter() - t0
        status = "ok" if kres <= krylov_gate else "stagnated"
        row = [pol.name, name, a.shape[0], a.nnz, int(synth),
               f"{pre.report.t_analyze:.4f}", f"{pre.report.t_factorize:.4f}",
               f"{t_apply:.4f}", pre.report.notes,
               pre.report.n_pivot_perturbed, f"{t_krylov:.4f}", kiters,
               f"{kres:.3e}", status, _ts()]
        _append(csv_path, ILU0_HEADER, row)
        out.append(dict(zip(ILU0_HEADER, row)))
        if verbose:
            print(f"[ilu0] {name}: factor={pre.report.t_factorize:.3f}s "
                  f"apply={t_apply*1e3:.1f}ms krylov={kres:.1e}/{kiters}it "
                  f"{status}{' (synthetic)' if synth else ''}")
    return out
