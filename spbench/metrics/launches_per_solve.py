"""launches_per_solve: the port's hand-written kernel launches a request in
the traced window (every kernel module's ``LAUNCHES``, raised over the
program's recording: K2 and K0 in the band cell; K4, K5 and K0 in the
frontal one), over the window's requests."""
from spbench.program import launches_per_request


def read(ctx):
    return launches_per_request(ctx)
