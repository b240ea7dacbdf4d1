"""95th percentile of the steady generations' wall times, from the program's
``explorer.generation`` spans (the traced window outside the profiled
stretch)."""

import statistics


def read(ctx):
    d = [s["dur"] / 1e6 for s in ctx.spans if s["name"] == "explorer.generation"
         and s["attrs"].get("gen") in ctx.steady_gens]
    if len(d) < 2:
        return None
    return statistics.quantiles(d, n=20, method="inclusive")[18]
