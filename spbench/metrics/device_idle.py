"""device_idle: 100 (1 - busy / window) over the traced window, busy being the
union of the device's kernel, copy and memset records."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.dev_names or ctx.trace.window_s <= 0:
        return None  # no device records: nothing ran on a card
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
