"""idle_unattributed: the share (%) of the window's device idle time, by
overlap, under no program span below ``solve_refined``: the idle time that
the program's spans do not name. None without device records."""


def read(ctx):
    share = getattr(ctx.trace, "idle_unattributed", None)
    return share() if share is not None else None
