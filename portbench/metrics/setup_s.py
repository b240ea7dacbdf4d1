"""Process start to the first timed generation: imports, the kernel's build
on a first run, the warm-up explore, the measured explore's initial
population and generation 0."""


def read(ctx):
    return ctx.setup_s
