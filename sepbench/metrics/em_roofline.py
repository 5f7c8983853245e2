"""em_roofline: the EM's least time on the card (``counts.em_work``:
the operations of the algorithm over 67 TFLOP/s or its bytes over
3.35 TB/s, the larger) over the device time of the kernels inside the
EM span, per call, in %."""
from sepbench.harness import counts


def read(ctx):
    span = ctx.trace.spans.get('em') if ctx.trace else None
    if not span or not span['device_s']:
        return None
    flops, moved = counts.em_work(ctx.config, ctx.batch)
    least_ms, _ = counts.bound(moved, flops)
    return 100 * least_ms / (1e3 * span['device_s'] / ctx.traced_calls)
