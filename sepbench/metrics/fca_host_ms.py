"""fca_host_ms: host ms per call of the program's ``fca`` span (the
refinement's fit and back-transform, as the host enqueues them), from
the program's own requests of the window's calls; nothing where the
program keeps no such span."""
from sepbench.harness import runner

# the window's requests of separate_batch, as step_init_ms takes them
_window = runner.load_module('metrics', 'step_init_ms')._window


def read(ctx):
    calls = _window(ctx)
    if calls is None:
        return None
    spans = [s for r in calls for s in r.spans if s.name == 'fca']
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(calls)
