"""refine_iters: the mean ``report.iterations`` of the window's refined
solves (plain IR's residuals, plus GMRES-IR's inner iterations where it
takes over)."""


def read(ctx):
    it = [s.iterations for s in ctx.steps]
    return sum(it) / len(it) if it else None
