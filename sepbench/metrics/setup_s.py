"""setup_s: seconds from the process's start to the end of the warm-up
call (loading, the kernels' build or load, the inputs, the warm-up)."""


def read(ctx):
    return ctx.setup_s
