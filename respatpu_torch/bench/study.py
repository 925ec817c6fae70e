"""The ReSpaSol precision study (the paper's experiment); the counterpart of
``respatpu/bench/study.py``.

For each corpus matrix, solve A x = b under five precision configurations and
record phase times and relative residuals:

  * df64     — the reference: a native fp64 factorization and solve (the name
               is respatpu's, whose fp64 is a double-float pair)
  * fp32     — fp32 factorization, raw
  * fp32_ftz — fp32 with subnormals flushed to zero (the paper's FTZ config)
  * fp32+ir  — fp32 factorization + fp64 iterative refinement to 1e-12 (the
               paper's conclusion: a low-precision factorization can give
               fp64-level accuracy)
  * bf16+ir  — bf16 factor values + fp64 refinement to 1e-12

Rows go to an append-mode CSV; :func:`summarize` gives the paper's headline,
the fp32 / fp64 factorization speedup and the residuals.

Two divergences from respatpu follow from fp64 being native on the card
(ROADMAP Queue 3): the ``df64`` row is an fp64 factorization and direct solve
on every method, where respatpu's multifrontal row is fp32 factors refined to
1e-14 in double-float (D5); and it is timed warm like the others, where
respatpu skips its minutes-long double-float refactorization (D6), so
``summarize`` divides a warm time by a warm time on every matrix.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import corpus
from .. import solve as slv

__all__ = ["CONFIGS", "HEADER", "run_study", "summarize"]

CONFIGS = ("df64", "fp32", "fp32_ftz", "fp32+ir", "bf16+ir")

HEADER = ["matrix", "n", "nnz", "synthetic", "config", "method", "t_factor_s",
          "t_factor_warm_s", "t_solve_s", "iterations", "rel_residual", "status", "timestamp"]


def run_study(names: Optional[Sequence[str]] = None, csv_path: Optional[str] = None,
              max_synth_nnz: Optional[int] = 2_000_000, max_band_bytes: int = 4 << 30,
              method: str = "auto", matching="auto", verbose: bool = True,
              device: Union[str, torch.device] = "cuda") -> List[dict]:
    """Each matrix goes through ``solve.factorize``'s chain (band, then
    multifrontal, then the scheduled sparse LU; GESP matching on for
    structurally unsymmetric patterns), as the reference's test program covers all
    matrices (test_pardiso.c:185-244); the serving method is recorded in
    each row. ``t_factor_warm_s`` is a second factorization of the same
    matrix. A refined row is ``ok`` when it reached the 1e-10 gate and
    ``stagnated`` when not; a factorization refused for lack of memory gives
    ``infeasible``, any other failure ``error`` (the row keeps going, as
    run_*.sh does). The study downloads nothing, where respatpu's first
    tries to (D7): the real matrices are those that ``python -m
    respatpu_torch fetch`` put on disk, else the stand-ins serve."""
    from .runner import _append, _ts
    names = names or [e.name for e in corpus.MODERATE]
    rows = []
    for name in names:
        a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
        b, _ = slv.make_rhs_for_known_x(a)
        for config in CONFIGS:
            t_warm = float("nan")
            used = ""
            fac = None
            try:
                policy = config[:-3] if config.endswith("+ir") else config
                fac = slv.factorize(a, policy=policy, method=method, matching=matching,
                                    max_band_bytes=max_band_bytes, device=device)
                used = fac.report.notes
                if config.endswith("+ir"):
                    x, rep = slv.solve_refined(a, b, fac=fac, tol=1e-12)
                else:
                    t_warm = fac.refactorize_timed()
                    x = fac.solve(b)
                    rep = fac.report
                # "ok" requires convergence: a refined config that stagnated
                # above its gate reads "stagnated" with its residual kept; the
                # raw configs report their residual for information
                # (test_superLU_MT.c:230-234)
                status = "ok" if rep.converged else "stagnated"
            except MemoryError:
                rep = slv.SolveReport(policy=config)
                status = "infeasible"
            except Exception as e:
                rep = slv.SolveReport(policy=config, notes=f"{type(e).__name__}: {e}")
                status = "error"
            del fac  # free this factor before the next configuration's
            row = dict(zip(HEADER, [name, a.shape[0], a.nnz, int(synth), config, used,
                                    round(rep.t_factorize, 4), round(t_warm, 4),
                                    round(rep.t_solve, 4), rep.iterations,
                                    f"{rep.residual:.3e}", status, _ts()]))
            _append(csv_path, HEADER, list(row.values()))
            rows.append(row)
            if verbose:
                print(f"[study] {name}/{config}: {status} [{used}] "
                      f"factor={rep.t_factorize:.3f}s resid={rep.residual:.2e}", flush=True)
    return rows


def summarize(rows: List[dict]) -> dict:
    """Paper-style summary: the fp32 / fp64 factorization speedup (warm
    times) and the residuals."""
    by = {}
    for r in rows:
        by.setdefault(r["matrix"], {})[r["config"]] = r
    speedups, resid32, resid_ir = [], [], []

    def t_of(r):
        tw = float(r.get("t_factor_warm_s", float("nan")))
        return tw if np.isfinite(tw) else float(r["t_factor_s"])

    for cfgs in by.values():
        if "df64" in cfgs and "fp32" in cfgs:
            t64 = t_of(cfgs["df64"])
            t32 = t_of(cfgs["fp32"])
            if t32 > 0 and cfgs["fp32"]["status"] == "ok":
                speedups.append(t64 / t32)
            if cfgs["fp32"]["status"] == "ok":
                resid32.append(float(cfgs["fp32"]["rel_residual"]))
        if "fp32+ir" in cfgs and cfgs["fp32+ir"]["status"] == "ok":
            resid_ir.append(float(cfgs["fp32+ir"]["rel_residual"]))
    return {
        "n_matrices": len(by),
        "fp32_vs_df64_factor_speedup_median": float(np.median(speedups)) if speedups else None,
        "fp32_residual_median": float(np.median(resid32)) if resid32 else None,
        "fp32_ir_residual_median": float(np.median(resid_ir)) if resid_ir else None,
        "fp32_ir_reaches_1e-10_frac": (float(np.mean([r < 1e-10 for r in resid_ir]))
                                       if resid_ir else None),
    }


if __name__ == "__main__":
    import sys
    print(json.dumps(summarize(run_study(sys.argv[1:] or None)), indent=2))
