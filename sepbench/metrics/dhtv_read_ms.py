"""dhtv_read_ms: ms per call of the program's ``dhtv.read`` spans after
the first of each ``dhtv`` span: the host reads of the alignment's
per-iteration loop, from the program's own requests of the window's
calls."""


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
            total += sum(s.end_ns - s.start_ns for s in reads[1:])
    return total / 1e6 / len(calls)
