"""Offspring evaluations completed in the window over its wall time."""


def read(ctx):
    return ctx.offspring * len(ctx.gen_s) / sum(ctx.gen_s) if ctx.gen_s else None
