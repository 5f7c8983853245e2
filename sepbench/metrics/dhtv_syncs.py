"""dhtv_syncs: host synchronizations with the device per call inside
the DHTV span, from the profiler's runtime events."""


def read(ctx):
    span = ctx.trace.spans.get('dhtv') if ctx.trace else None
    if not span or not span['count']:
        return None
    return span['syncs'] / ctx.traced_calls
