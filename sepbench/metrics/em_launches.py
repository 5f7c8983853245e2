"""em_launches: launches per call of the EM kernels (the whole fit, the
streamed statistics pass, the batched Jacobi), from the program's own
launch counters over the window."""
COUNTERS = ('pb_bss_tpu_torch.ops.em_loop.cacgmm_em_full',
            'pb_bss_tpu_torch.ops.em_stream.e_stats',
            'pb_bss_tpu_torch.ops.eigh.eigh_jacobi')


def read(ctx):
    if not ctx.calls:
        return None
    return sum(ctx.counters[c] for c in COUNTERS) / ctx.calls
