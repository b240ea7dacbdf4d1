"""``sim_step`` device milliseconds per launch in the profiled stretch, by
kernel name."""

NAME = "sim_step_kernel"


def read(ctx):
    d = [e["dur"] for e in ctx.device_events if e["cat"] == "kernel" and NAME in e["name"]]
    return sum(d) / len(d) / 1e3 if d else None
