"""dhtv_iterations: DHTV iterations that ran per call (the program's
counter ``dhtv.iterations``; a host read that ends a block early runs
none), from the program's own requests of the window's calls."""


def _window(ctx):
    """The window's requests of ``separate_batch`` (the last calls of the
    run), or None where the program keeps no requests or too few."""
    try:
        from pb_bss_tpu_torch.utils import profiling
        done = profiling.requests()
    except (ImportError, AttributeError):
        return None
    calls = [r for r in done if r.root == 'separate_batch']
    if not ctx.calls or len(calls) < ctx.calls:
        return None
    return calls[-ctx.calls:]


def read(ctx):
    calls = _window(ctx)
    if calls is None:
        return None
    return sum(r.counters.get('dhtv.iterations', 0) for r in calls) \
        / len(calls)
