"""Where a multifrontal factorization's and a solve's time goes on the card.

    python -m respatpu_torch.bench.frontal_probe [dc1 2cubes_sphere ...] [--policy fp32]

For each corpus matrix (stand-ins at catalogue size): ``factorize(a, policy,
method="snlu")`` with its phase times and the plan's shape, then one warm
factorization and one solve under the profiler: wall time, the card's busy
time, and the busy time by kernel name.

Needs a CUDA card; ``chip_smoke.py`` holds the checks.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import solve as slv
from ..kernels import _build
from ..timing import busy_by_name, card_line, device_events
from . import corpus


def _profile(tag, card, fn):
    """Run ``fn`` (which ends in a device synchronize) once bare and once
    under the profiler; print wall, busy, and the busiest kernels."""
    wall = [0.0]

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall[0] = time.perf_counter() - t0

    timed()
    bare = wall[0]
    events = device_events(timed)
    busy = sum(t for _, t in events)
    print(f"[{tag}] {card} | wall {bare * 1e3:.1f} ms ({wall[0] * 1e3:.1f} ms under the "
          f"profiler), device busy {busy * 1e3:.1f} ms in {len(events)} records", flush=True)
    for key, n, tot in busy_by_name(events):
        print(f"[{tag}]   {key}: {n} x {tot / n * 1e6:.1f} us = {tot * 1e3:.2f} ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("matrices", nargs="*", default=["dc1", "2cubes_sphere"])
    ap.add_argument("--policy", default="fp32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frontal_probe needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    _build.load()
    for name in args.matrices:
        a, _ = corpus.load_matrix(name)
        b, _ = slv.make_rhs_for_known_x(a)
        fac = slv.factorize(a, args.policy, method="snlu", device="cuda")
        plan, ph = fac._plan, fac.phases
        wide = sorted(((g.wp, g.rp, g.nfronts) for g in plan.groups), reverse=True)[:6]
        fronts = np.array([g.nfronts for g in plan.groups])
        print(f"[plan] {card} | {name} n={a.nrows} nnz={a.nnz} [{fac.report.notes}] fronts "
              f"{fac.part.nsn} in {len(plan.groups)} groups over {len(fac.part.levels)} levels "
              f"(median group {int(np.median(fronts))} fronts, largest {int(fronts.max())}), "
              f"fill {fac.part.fill_nnz}, pool {fac.report.factor_bytes / 1e9:.2f} GB, widest "
              f"groups (wp, rp, fronts) {wide}; analyze {fac.report.t_analyze:.2f} s (matching "
              f"{ph['matching']:.2f}, ordering and symbolic {ph['symbolic']:.2f}, plan "
              f"{ph['plan']:.2f}), factor cold {fac.report.t_factorize * 1e3:.1f} ms, "
              f"{fac._frontal.launches_per_solve} launches a solve", flush=True)
        _profile(f"factor {name}", card, fac.refactorize_timed)
        bd = torch.from_numpy(b).cuda()
        _profile(f"solve {name}", card, lambda: fac.solve_original_device(bd))
        del fac


if __name__ == "__main__":
    main()
