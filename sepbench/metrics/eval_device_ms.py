"""eval_device_ms: device ms per call of the kernels launched inside
the evaluation span (BSS-Eval and the STOI of its selection)."""


def read(ctx):
    span = ctx.trace.spans.get('eval') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    return 1e3 * span['device_s'] / ctx.traced_calls
