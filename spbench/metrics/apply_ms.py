"""apply_ms: host milliseconds a request in the program's ``apply`` spans,
the correction and preconditioner solves as the host enqueues them (K2, or
K4 and K5 group by group), over the window's requests."""
from spbench.program import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "apply")
