"""solve_p95_ms: the 95th percentile (linear between order statistics) of
every refined solve of the window, each timed on the host from request to
answer."""
import numpy as np


def read(ctx):
    lat = [s.latency_s for s in ctx.steps]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
