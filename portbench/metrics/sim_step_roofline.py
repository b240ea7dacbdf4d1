"""``sim_step``'s share of its roofline: the least time a launch of the
cell's shape can take (its bytes over the published HBM bandwidth, see
``portbench/yardstick.py``) over its mean device time in the stretch."""

from portbench.yardstick import sim_step_bound_s

NAME = "sim_step_kernel"


def read(ctx):
    if ctx.shape is None:
        return None
    d = [e["dur"] for e in ctx.device_events if e["cat"] == "kernel" and NAME in e["name"]]
    if not d:
        return None
    return 100.0 * sim_step_bound_s(ctx.shape, ctx.device_name) / (sum(d) / len(d) / 1e6)
