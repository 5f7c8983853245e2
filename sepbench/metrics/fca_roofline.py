"""fca_roofline: the FCA refinement's least time on the card
(``fca_counts.fca_work``: its operations over 67 TFLOP/s or its bytes
over 3.35 TB/s, the larger) over the device time of the operations
inside its spans, per call, in %."""
from sepbench.harness import fca_counts


def read(ctx):
    span = ctx.trace.spans.get('fca') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    least_ms = fca_counts.fca_bound_ms(ctx.config, ctx.batch)
    return 100 * least_ms / (1e3 * span['device_s'] / ctx.traced_calls)
