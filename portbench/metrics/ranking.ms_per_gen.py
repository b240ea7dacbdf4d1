"""Ranking and truncation of the merged population: milliseconds a steady
generation spends in ``evo.execute`` spans of kind ``rank``."""


def read(ctx):
    return ctx.per_steady_gen_ms("rank")
