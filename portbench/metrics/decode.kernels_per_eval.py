"""Device kernels per relaxed evaluation in the profiled stretch: kernels
whose launch lies inside an ``evo.execute`` span of kind ``eval``, over the
number of such spans."""


def read(ctx):
    evals = [s for s in ctx.stretch_spans
             if s["name"] == "evo.execute" and s["attrs"].get("kind") == "eval"]
    if not evals:
        return None
    n = sum(1 for e in ctx.device_events if e["cat"] == "kernel" and e["launch"] is not None
            and any(s["ts_us"] <= e["launch"] <= s["end_us"] for s in evals))
    return n / len(evals) if n else None
