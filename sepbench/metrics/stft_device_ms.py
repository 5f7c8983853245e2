"""stft_device_ms: device ms per call of the kernels launched inside
the STFT and iSTFT spans."""


def read(ctx):
    span = ctx.trace.spans.get('stft') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    return 1e3 * span['device_s'] / ctx.traced_calls
