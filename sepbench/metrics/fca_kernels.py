"""fca_kernels: device operations (kernels, copies, sets) per call
launched inside the FCA refinement's spans."""


def read(ctx):
    span = ctx.trace.spans.get('fca') if ctx.trace else None
    if not span or not span['operations']:
        return None
    return span['operations'] / ctx.traced_calls
