"""bf_device_ms: device ms per call of the kernels inside the
beamformer's spans (PSDs, GEV+BAN, phase chaining, the output)."""


def read(ctx):
    span = ctx.trace.spans.get('beamformer') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    return 1e3 * span['device_s'] / ctx.traced_calls
