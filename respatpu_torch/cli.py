"""Command-line drivers of the port:

  python -m respatpu_torch spmv  <matrix.mtx|corpus-name> [--policy fp32] [--csv out.csv]
  python -m respatpu_torch lu    <matrix.mtx|corpus-name> [--method auto|band|snlu|sparse|subtree]
                                 [--refine] [--matching auto|on|off] [--shards P]
  python -m respatpu_torch ilu0  <matrix.mtx|corpus-name> [--policy fp32] [--sweeps 8]
  python -m respatpu_torch sweep spmv|lu|ilu0|ilu0dist [--group moderate|big|all] [--shards P]
  python -m respatpu_torch study [matrix ...] [--csv out.csv] [--max-synth-nnz N]
  python -m respatpu_torch scaling [corpus-name] [--shards 1 2 4 8]
  python -m respatpu_torch fetch [moderate|big|all]

All but ``fetch`` run on ``--device cuda`` (the default), through the
hand-written kernels; without a card they refuse to run unless ``--device
cpu`` is given, which runs the kernels' plain PyTorch versions on the host.
The high precision is fp64; ``--policy`` picks the low one (fp32 | fp32_ftz |
bf16). ``study`` prints the summary of the precision study as JSON; it
downloads nothing: ``fetch`` puts the real matrices on disk.

``lu`` solves once with the factorization unless ``--refine`` asks for
fp64 iterative refinement, as respatpu's does; it warns on stderr when a
refined or fp64 residual is above 1e-10.

The distributed commands (``lu --method subtree``, ``sweep ilu0dist``,
``scaling``) run on a mesh of ``--shards`` shards on the cards round-robin
(``dist.make_mesh``): where respatpu takes every local device, ``--shards``
lets one card hold several shards, which runs the distributed path there but
measures no scaling. Started in a process group (``dist.init_distributed``
from a script, or torchrun), ``lu --method subtree`` and ``sweep ilu0dist``
spread their shards over its ranks, and rank 0 prints; ``scaling`` refuses.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

def _load(spec: str):
    from .bench.corpus import _BY_NAME, load_matrix
    if os.path.exists(spec):
        from .io import load_csr
        return load_csr(spec), False, os.path.basename(spec)
    if spec in _BY_NAME:
        a, synth = load_matrix(spec)
        return a, synth, spec
    raise SystemExit(f"matrix {spec!r}: no such file or corpus entry")


_MATCHING = {"auto": "auto", "on": True, "off": False}


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
    if args.method == "subtree":
        # distributed (the MUMPS job=4/3 slot): the subtree-sharded multifrontal LU
        from .dist import make_mesh
        from .dist_snlu_sub import DistSubtreeLu
        fac = DistSubtreeLu(a, mesh=make_mesh(args.shards, device), policy=args.policy)
        fac.report.notes = (f"method=subtree {fac.mesh.describe()} "
                            f"local_pool={fac.local_pool_bytes / 2**20:.0f}MiB "
                            f"(replicated {fac.replicated_pool_bytes / 2**20:.0f})")
        x = fac.solve_refined(b) if args.refine else fac.solve(b)
        rep = fac.report
        if fac.mesh.rank:
            return
        print(f"{name}{' (synthetic)' if synth else ''}: policy={rep.policy} "
              f"[{rep.notes}] analyze={rep.t_analyze:.3f}s "
              f"factor={rep.t_factorize:.3f}s solve={rep.t_solve:.3f}s "
              f"rel_residual={rep.residual:.3e} "
              f"inf_err={slv.inf_norm_error(x, x_true):.3e}")
        return
    fac = slv.factorize(a, policy=args.policy, method=args.method,
                        matching=_MATCHING[args.matching], device=device)
    if args.refine:
        x, rep = slv.solve_refined(a, b, fac=fac)
    else:
        x = fac.solve(b)
        rep = fac.report
    print(f"{name}: policy={rep.policy} [{fac.report.notes}] "
          f"analyze={rep.t_analyze:.3f}s factorize={rep.t_factorize:.3f}s "
          f"solve={rep.t_solve:.3f}s iterations={rep.iterations} "
          f"rel_residual={rep.residual:.3e} "
          f"inf_norm_error={slv.inf_norm_error(x, x_true):.3e} "
          f"pivots_perturbed={rep.n_pivot_perturbed} device={device}"
          f"{' (synthetic)' if synth else ''}")
    if rep.residual > 1e-10 and (fac.policy.name == "fp64" or args.refine):
        print("WARNING: residual above 1e-10 gate", file=sys.stderr)


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
    from .bench import corpus, runner
    device = _device(args.device)
    entries = {"moderate": corpus.MODERATE, "big": corpus.BIG,
               "all": corpus.ALL}[args.group]
    kw = {}
    if args.max_synth_nnz is not None:
        kw["max_synth_nnz"] = args.max_synth_nnz
    if args.kind == "ilu0dist":
        if args.shards is not None:
            kw["ndev"] = args.shards
        runner.run_sweep("ilu0dist", group=args.group, csv_path=args.csv, device=device, **kw)
        return
    if args.kind == "ilu0":
        runner.sweep_ilu0([e.name for e in entries], csv_path=args.csv, policy=args.policy,
                          sweeps=args.sweeps, device=device, **kw)
        return
    if args.kind == "lu":
        runner.sweep_lu([e.name for e in entries], csv_path=args.csv,
                        policy=args.policy, method=args.method,
                        matching=_MATCHING[args.matching], refine=not args.no_refine,
                        device=device, **kw)
        return
    runner.sweep_spmv([e.name for e in entries], csv_path=args.csv,
                      policies=("fp64", args.policy), reps=args.reps,
                      device=device, **kw)


def cmd_fetch(args):
    from .bench import fetch
    fetch.main([args.group])


def cmd_study(args):
    import json
    from .bench import study
    rows = study.run_study(args.matrices or None, csv_path=args.csv,
                           max_synth_nnz=args.max_synth_nnz, device=_device(args.device))
    print(json.dumps(study.summarize(rows), indent=2))


def cmd_scaling(args):
    import json
    from .bench import scaling
    kw = {} if args.max_synth_nnz is None else {"max_synth_nnz": args.max_synth_nnz}
    print(json.dumps(scaling.measure_scaling(args.matrix, device_counts=args.shards,
                                             device=_device(args.device), **kw), indent=2))


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
                        choices=["auto", "band", "snlu", "multifrontal", "sparse", "subtree"],
                        help="auto (band, then multifrontal, then the scheduled sparse "
                             "LU) | band | snlu (= multifrontal) | sparse | subtree (the "
                             "distributed multifrontal LU on --shards shards)")
        sp.add_argument("--matching", default="auto", choices=["auto", "on", "off"],
                        help="GESP weighted matching + Ruiz scaling (auto = on for "
                             "structurally unsymmetric; the band and subtree methods take none)")
        sp.add_argument("--shards", type=int, default=None,
                        help="shards of a distributed run (lu --method subtree: default one "
                             "a card; sweep ilu0dist: default 8), on the cards round-robin")

    sp = sub.add_parser("lu", help="direct LU factorize + solve")
    sp.add_argument("matrix")
    common(sp)
    direct(sp)
    how = sp.add_mutually_exclusive_group()  # one direct solve unless asked, as respatpu's
    how.add_argument("--refine", action="store_true",
                     help="fp64 iterative refinement after the direct solve")
    how.add_argument("--no-refine", action="store_true",
                     help="one direct solve, no refinement (the default)")
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
    sp.add_argument("--no-refine", action="store_true",  # sweep lu refines, as respatpu's
                    help="one direct solve, no fp64 iterative refinement (sweep lu)")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("fetch", help="download the SuiteSparse corpus")
    sp.add_argument("group", nargs="?", default="moderate",
                    choices=["moderate", "big", "all"])
    sp.set_defaults(fn=cmd_fetch)

    sp = sub.add_parser("study", help="the precision study (five configurations a matrix)")
    sp.add_argument("matrices", nargs="*")
    sp.add_argument("--csv", default=None)
    sp.add_argument("--max-synth-nnz", type=int, default=500_000)
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_study)

    sp = sub.add_parser("scaling", help="distributed SpMV at several shard counts")
    sp.add_argument("matrix", nargs="?", default="atmosmodd")
    sp.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="shard counts, on the cards round-robin (a count above the cards "
                         "is marked: not a scaling result)")
    sp.add_argument("--max-synth-nnz", type=int, default=None)
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_scaling)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
