"""Relaxed decode, ``sim_step`` included: milliseconds a steady generation
spends in the program's ``evo.execute`` spans of kind ``eval`` (they wait
for the device while recording)."""


def read(ctx):
    return ctx.per_steady_gen_ms("eval")
