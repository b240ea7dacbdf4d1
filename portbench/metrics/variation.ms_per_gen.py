"""Variation (ranking of the parents, tournaments, crossover, mutation):
milliseconds a steady generation spends in ``evo.execute`` spans of kind
``vary``."""


def read(ctx):
    return ctx.per_steady_gen_ms("vary")
