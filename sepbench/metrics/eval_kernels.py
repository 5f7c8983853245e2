"""eval_kernels: device operations (kernels, copies, sets) per call
launched inside the evaluation span."""


def read(ctx):
    span = ctx.trace.spans.get('eval') if ctx.trace else None
    if not span or not span['operations']:
        return None
    return span['operations'] / ctx.traced_calls
