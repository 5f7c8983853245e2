"""fca_device_ms: device ms per call of the operations launched inside
the FCA refinement's spans (the fit and the back-transform; the
batched Jacobi kernels of their pseudo-inverse fallbacks found by
name)."""


def read(ctx):
    span = ctx.trace.spans.get('fca') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    return 1e3 * span['device_s'] / ctx.traced_calls
