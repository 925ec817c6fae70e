"""tri_chain: the triangular solves' chain floor over their device time, in %.
A correction apply of the scheduled sparse LU is one launch of K7
(``tri_solve_kernel``) on L and one on U, and each walks its levels in turn,
a level waiting on the one before: at least one hand-over through L2 a level
(frozen ``link_s``, the link probe's). A solve of i iterations is counted as
i - 1 applies, so the window's floor is the sum over its requests of
(i - 1) (``lower_levels`` + ``upper_levels``) ``link_s``; it is divided by
the device time of the K7 records inside the benchmark's solve spans. Each
level is counted at its least, under GMRES-IR as under IR, so this is a
floor."""
import numpy as np

from spbench.trace import _overlap, _union

KERNEL = "tri_solve_kernel"


def read(ctx):
    w, tr = ctx.work, ctx.trace
    if tr is None or "link_s" not in w or not ctx.steps:
        return None
    spans = tr.spans.get("solve") or []
    ours = np.fromiter((KERNEL in n for n in tr.dev_names), bool, len(tr.dev_names))
    if not spans or not ours.any():
        return None
    us, ue = _union(tr.dev_start[ours], tr.dev_end[ours])
    busy = sum(_overlap(us, ue, s, e) for s, e in spans) * 1e-9
    if busy <= 0:
        return None
    applies = sum(max(s.iterations - 1, 0) for s in ctx.steps)
    floor = applies * (w["lower_levels"] + w["upper_levels"]) * w["link_s"]
    return 100.0 * floor / busy
