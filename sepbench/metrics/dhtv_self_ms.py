"""dhtv_self_ms: ms per call of the program's ``dhtv`` span less its
first ``dhtv.read``, which waits for the work queued before the
alignment (mostly the EM): the alignment's own loop, from the
program's own requests of the window's calls."""


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
    total = 0
    for request in calls:
        for index, span in enumerate(request.spans):
            if span.name != 'dhtv':
                continue
            # in the order they opened
            reads = [s for s in request.spans
                     if s.name == 'dhtv.read' and s.parent == index]
            total += span.end_ns - span.start_ns - (
                reads[0].end_ns - reads[0].start_ns if reads else 0)
    return total / 1e6 / len(calls)
