"""sep_mfu: the whole separation step's share of the card's float32
peak: the operations one call needs, counted from shapes
(``counts.separation_flops``), over the median wall time of the calls
outside the profiled stretch times 67 TFLOP/s."""
import statistics

from sepbench.harness import counts


def read(ctx):
    if not ctx.call_times:
        return None
    seconds = statistics.median(ctx.call_times)
    flops = counts.separation_flops(ctx.config, ctx.batch)
    return 100 * flops / (seconds * counts.PEAK_FP32_FLOP_PER_S)
