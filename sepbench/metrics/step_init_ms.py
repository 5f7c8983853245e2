"""step_init_ms: ms per call of the program's ``init`` span (the EM
initialization's generators and draws, the host read of their seeds
included), from the program's own requests of the window's calls."""


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
    ns = sum(s.end_ns - s.start_ns for r in calls for s in r.spans
             if s.name == 'init')
    return ns / 1e6 / len(calls)
