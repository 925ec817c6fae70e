"""setup_s: seconds from the process's start to the first request of the
window: imports, the kernel libraries, the stand-in, ``factorize`` (analysis,
upload, first factorization) and the warm-up requests. Host clock."""


def read(ctx):
    return ctx.setup_s
