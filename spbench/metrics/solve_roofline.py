"""solve_roofline: the least bytes the window's refined solves move, over the
HBM peak, over the device's busy time inside the solve spans, in %. A solve
of i iterations is counted as i - 1 correction applies (the factor's entries
once each, frozen ``apply_bytes``) and i fp64 residual products (frozen
``csr64_bytes``); a GMRES-IR solve does more of both, so this is a floor."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    busy = ctx.trace.busy_in("solve")
    if not busy:
        return None
    w = ctx.work
    nbytes = sum(max(s.iterations - 1, 0) * w["apply_bytes"] + s.iterations * w["csr64_bytes"]
                 for s in ctx.steps)
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / busy
