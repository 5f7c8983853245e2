"""dhtv_ms: wall ms per call of the DHTV span on the host clock (its
synchronizations with the device included), over the calls of a traced
run outside the profiled stretch."""


def read(ctx):
    times = ctx.span_host_times.get('dhtv')
    if not times or not ctx.call_times:
        return None
    return 1e3 * sum(times) / len(ctx.call_times)
