"""solve_ms: the window's milliseconds over the refined solves completed in
it (a solve that reports it did not converge is not completed). Host clock,
from the first request to the last answer."""


def read(ctx):
    done = sum(s.converged for s in ctx.steps)
    return 1e3 * ctx.window_s / done if done else None
