"""sep_batch_ms_p95: the 95th percentile of the wall time of every
call of the window, each from the call to the end of
``torch.cuda.synchronize()``."""
from sepbench.harness.runner import percentile


def read(ctx):
    return 1e3 * percentile(ctx.call_times, 95)
