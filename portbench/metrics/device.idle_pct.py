"""Share of the profiled stretch in which no kernel, copy or fill ran on the
device."""


def read(ctx):
    a, b = ctx.stretch
    if b <= a or not ctx.device_events:
        return None
    return 100.0 * (1.0 - ctx.busy_us() / (b - a))
