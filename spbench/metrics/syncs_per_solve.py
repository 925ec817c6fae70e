"""syncs_per_solve: the program's ``sync`` counter (each host wait on the
device in the refined solve: a norm read, H pulled, x pulled) over the
window's requests."""
from spbench.program import count_per_request


def read(ctx):
    return count_per_request(ctx, "sync")
