"""Command-line drivers of the port:

  python -m respatpu_torch spmv  <matrix.mtx|corpus-name> [--policy fp32] [--csv out.csv]
  python -m respatpu_torch lu    <matrix.mtx|corpus-name> [--method auto|band|snlu|sparse] [--no-refine]
  python -m respatpu_torch ilu0  <matrix.mtx|corpus-name> [--policy fp32] [--sweeps 8]
  python -m respatpu_torch sweep spmv|lu|ilu0 [--group moderate|big|all]

All run on ``--device cuda`` (the default), through the hand-written
kernels; without a card they refuse to run unless ``--device cpu`` is given,
which runs the kernels' plain PyTorch versions on the host. The high
precision is fp64; ``--policy`` picks the low one (fp32 | fp32_ftz | bf16).
respatpu's other subcommands (sweep ilu0dist, fetch, study, scaling) are not
ported yet.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_NOT_PORTED = ("fetch", "study", "scaling")


def _load(spec: str):
    from .bench.corpus import _BY_NAME, load_matrix
    if os.path.exists(spec):
        from .io import load_csr
        return load_csr(spec), False, os.path.basename(spec)
    if spec in _BY_NAME:
        a, synth = load_matrix(spec)
        return a, synth, spec
    raise SystemExit(f"matrix {spec!r}: no such file or corpus entry")


def _device(spec: str) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the "
                         "plain PyTorch version on the host")
    return device


def cmd_spmv(args):
    from .bench import runner
    device = _device(args.device)
    if os.path.exists(args.matrix):
        from . import solve as slv
        a, _, name = _load(args.matrix)
        x = np.random.default_rng(args.seed).standard_normal(a.shape[1])
        y_hi, t_hi = slv.spmv_timed(a, x, "fp64", device=device, reps=args.reps)
        y_lo, t_lo = slv.spmv_timed(a, x, args.policy, device=device, reps=args.reps)
        err = float(np.abs(slv._to_host_f64(y_hi) - slv._to_host_f64(y_lo)).mean())
        print(f"{name}: t_fp64={t_hi.median*1e6:.3f}us "
              f"t_{args.policy}={t_lo.median*1e6:.3f}us "
              f"mean_abs_err={err:.3e} device={device}")
    else:
        runner.sweep_spmv([args.matrix], csv_path=args.csv,
                          policies=("fp64", args.policy), reps=args.reps,
                          device=device)


def cmd_lu(args):
    from . import solve as slv
    device = _device(args.device)
    a, synth, name = _load(args.matrix)
    b, x_true = slv.make_rhs_for_known_x(a)
    fac = slv.factorize(a, policy=args.policy, method=args.method, device=device)
    if args.no_refine:
        x = fac.solve(b)
        rep = fac.report
    else:
        x, rep = slv.solve_refined(a, b, fac=fac)
    print(f"{name}: policy={rep.policy} [{fac.report.notes}] "
          f"analyze={rep.t_analyze:.3f}s factorize={rep.t_factorize:.3f}s "
          f"solve={rep.t_solve:.3f}s iterations={rep.iterations} "
          f"rel_residual={rep.residual:.3e} "
          f"inf_norm_error={slv.inf_norm_error(x, x_true):.3e} "
          f"pivots_perturbed={rep.n_pivot_perturbed} device={device}"
          f"{' (synthetic)' if synth else ''}")


def cmd_ilu0(args):
    from . import solve as slv
    device = _device(args.device)
    a, synth, name = _load(args.matrix)
    pre = slv.Ilu0Preconditioner(a, policy=args.policy, sweeps=args.sweeps, device=device)
    r = pre.report
    print(f"{name}{' (synthetic)' if synth else ''}: "
          f"analyze={r.t_analyze:.3f}s factor={r.t_factorize:.3f}s "
          f"pivots_perturbed={r.n_pivot_perturbed} {r.notes} device={device}")


def cmd_sweep(args):
    if args.kind not in ("spmv", "lu", "ilu0"):
        raise SystemExit(f"sweep {args.kind} is not ported to respatpu_torch yet")
    from .bench import corpus, runner
    device = _device(args.device)
    entries = {"moderate": corpus.MODERATE, "big": corpus.BIG,
               "all": corpus.ALL}[args.group]
    kw = {}
    if args.max_synth_nnz is not None:
        kw["max_synth_nnz"] = args.max_synth_nnz
    if args.kind == "ilu0":
        runner.sweep_ilu0([e.name for e in entries], csv_path=args.csv, policy=args.policy,
                          sweeps=args.sweeps, device=device, **kw)
        return
    if args.kind == "lu":
        runner.sweep_lu([e.name for e in entries], csv_path=args.csv,
                        policy=args.policy, method=args.method,
                        refine=not args.no_refine, device=device, **kw)
        return
    runner.sweep_spmv([e.name for e in entries], csv_path=args.csv,
                      policies=("fp64", args.policy), reps=args.reps,
                      device=device, **kw)


def _not_ported(args):
    raise SystemExit(f"{args.cmd} is not ported to respatpu_torch yet; "
                     f"use python -m respatpu {args.cmd}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="respatpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--policy", default="fp32",
                        help="fp32 | fp32_ftz | bf16 | fp64 (df64 is an alias)")
        sp.add_argument("--csv", default=None)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--reps", type=int, default=5)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; the CSR kernel) or cpu")

    sp = sub.add_parser("spmv", help="dual-precision SpMV benchmark")
    sp.add_argument("matrix")
    common(sp)
    sp.set_defaults(fn=cmd_spmv)

    def direct(sp):
        sp.add_argument("--method", default="auto",
                        choices=["auto", "band", "snlu", "multifrontal", "sparse"],
                        help="auto (band, then multifrontal, then the scheduled sparse "
                             "LU) | band | snlu (= multifrontal) | sparse")
        sp.add_argument("--no-refine", action="store_true",
                        help="one direct solve, no fp64 iterative refinement")

    sp = sub.add_parser("lu", help="direct LU factorize + refined solve")
    sp.add_argument("matrix")
    common(sp)
    direct(sp)
    sp.set_defaults(fn=cmd_lu)

    sp = sub.add_parser("ilu0", help="ILU(0) factorization (Chow-Patel sweeps)")
    sp.add_argument("matrix")
    sp.add_argument("--sweeps", type=int, default=8)
    common(sp)
    sp.set_defaults(fn=cmd_ilu0)

    sp = sub.add_parser("sweep", help="corpus sweep")
    sp.add_argument("kind", choices=["spmv", "ilu0", "lu", "ilu0dist"])
    sp.add_argument("--group", default="moderate",
                    choices=["moderate", "big", "all"])
    sp.add_argument("--max-synth-nnz", type=int, default=None,
                    help="cap synthetic stand-in size (default: per-sweep)")
    sp.add_argument("--sweeps", type=int, default=8, help="ILU(0) sweeps (sweep ilu0)")
    common(sp)
    direct(sp)
    sp.set_defaults(fn=cmd_sweep)

    for name in _NOT_PORTED:
        sp = sub.add_parser(name, help="not ported yet")
        sp.add_argument("rest", nargs=argparse.REMAINDER)
        sp.set_defaults(fn=_not_ported)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
