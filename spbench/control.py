"""Readings that set a configuration's limits: the program's on many seeds,
and the control's, the reference put in the program's place one precision
below the configuration's (``spbench/reference.py``), on the card at the
cell's own size.

    python -m spbench.control --config <name> --program-seeds 1,2,... \
        --control-seeds 101,102,103 [--witness 1] [--out <file>]

For each program seed: the run's matrix, ``factorize``, one
refactorization, one refined solve of a window right-hand side, and the
factor probed as a run probes it; for each control seed the same with the
control in the program's place (the refinement is the program's), and with
``--witness 1`` the same reference at the configuration's precision beside
it. Prints one JSON line a seed, and every line to ``--out`` as well. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):
    sys.path.insert(0, str(HERE.parent))

from spbench import reference, run, standin  # noqa: E402


def reading(cfg: dict, m, a, fac, seed: int, device: str, who: str) -> dict:
    from respatpu_torch import solve as S
    import numpy as np
    b = standin.Images(m, device).chunk(seed, 1, 0, 1)[0]
    t0 = time.perf_counter()
    try:
        x, rep = S.solve_refined(a, b, fac=fac)
        it, conv, notes = int(rep.iterations), bool(rep.converged), str(rep.notes)
    except Exception as e:       # a control may break the refinement: no answer
        x, it, conv, notes = np.full(m.n, np.nan), 0, False, f"raised {type(e).__name__}: {e}"
    t_solve = time.perf_counter() - t0
    probes = run.probe_factor(fac, m.n, seed, int(cfg.get("probes", 2)), device)
    checks, correct = run.judge(m, probes, [(x, b)], cfg["limits"])
    row = {"who": who, "seed": seed, "correct": correct}
    row.update({k: c["value"] for k, c in checks.items()})
    row.update(iterations=it, converged=conv, solve_s=t_solve, notes=notes[:200])
    return row


def _free(device: str) -> None:
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def readings(cfg: dict, seeds, cseeds, witness: bool, device: str):
    """The program's reading on each of ``seeds``, then the control's (and
    with ``witness`` the reference's at the configuration's precision) on
    each of ``cseeds``, one dict each."""
    fixed = not cfg["matrix"].get("scale_values", True)   # one matrix for every seed
    fac = None
    for seed in seeds:
        t0 = time.perf_counter()
        if fac is None or not fixed:
            fac = None
            _free(device)
            m, a, fac = run.build(cfg, seed, device)
        t_build = time.perf_counter() - t0
        fac.refactorize_timed()
        row = reading(cfg, m, a, fac, seed, device, "program")
        row.update(build_s=t_build, n_pivot_perturbed=int(fac.report.n_pivot_perturbed))
        yield row
    fac = None
    _free(device)
    for seed in cseeds:
        m, a = run.matrix(cfg, seed)
        ref = reference.PlainCsr(m.shape, m.indptr, m.indices, m.data)
        for tf32 in ((True, False) if witness else (True,)):
            t0 = time.perf_counter()
            ctl = reference.control_factor(cfg["control"], ref, device, tf32=tf32)
            t_build = time.perf_counter() - t0
            row = reading(cfg, m, a, ctl, seed, device, "control" if tf32 else "reference_fp32")
            row["control"] = cfg["control"]
            row.update(build_s=t_build)
            del ctl
            _free(device)
            yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spbench.control")
    p.add_argument("--config", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = run.load_json(HERE / "configs" / f"{args.config}.json")
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row["config"] = args.config
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for row in readings(cfg, seeds, cseeds, bool(args.witness), "cuda"):
        emit(row)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
