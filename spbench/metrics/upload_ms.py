"""upload_ms: milliseconds a request in the program's ``upload`` spans (the
fp64 operator made and copied to the card with b and x0, its ``layout``
inside, in plain IR and again in GMRES-IR), over the window's requests."""
from spbench.program import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "upload")
