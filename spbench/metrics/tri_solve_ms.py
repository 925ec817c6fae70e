"""tri_solve_ms: host milliseconds a request in the program's ``tri_solve``
spans (the scheduled sparse LU's correction applies: K7 on L and on U, as
the host enqueues them), over the window's requests."""
from spbench.program import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "tri_solve")
