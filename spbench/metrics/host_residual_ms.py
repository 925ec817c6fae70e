"""host_residual_ms: milliseconds a request in the program's
``host_residual`` spans (``relative_residual``, the fp64 residual on the
host, once a solve and again after GMRES-IR), over the window's requests."""
from spbench.program import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "host_residual")
