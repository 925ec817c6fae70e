"""analyze_s: the program's own timer of its analysis (``fac.report.t_analyze``,
to a synchronize): ordering, matching and scaling, the symbolic phase, the
plan and the upload."""


def read(ctx):
    return ctx.analyze_s
