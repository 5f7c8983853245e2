"""The readings a cell's limits are set from.

``program``: the numbers the check compares, for calls of the system
under test at the cell's own size (what a run's sampled calls give).
``control``: the same numbers with the reference, in TF32, put in the
program's place. ``program_tf32``: the system with its own TF32 switch
on (``set_em_matmul_precision('high')``, which reaches its PyTorch
matrix products: the PSDs and DHTV's scores; its kernels stay float32).
Every reading comes from the same driver and check as a run.
"""
from __future__ import annotations

from sepbench.harness import runner, spans


def _driver(cell, seed, torch, device):
    runner.import_program()
    driver = runner.make_driver(cell, seed, torch, device)
    driver.setup()
    return driver


def _numbers(driver, samples, limits):
    rows, info = runner.check(driver, samples, limits)
    return dict({name: value for name, value, _ in rows}, **info)


def program(cell, seed, calls, torch, device, tf32=False):
    """{number: value} over calls 0..calls-1 of the system, each
    captured as a run captures it."""
    driver = _driver(cell, seed, torch, device)
    wrappers = spans.Wrappers()
    driver.install(wrappers)
    previous = None
    if tf32:
        from pb_bss_tpu_torch.models._precision import \
            set_em_matmul_precision
        previous = set_em_matmul_precision('high')
    try:
        driver.call(-1, capture=True)
        samples = [(i, driver.call(i, capture=True)[1])
                   for i in range(calls)]
    finally:
        wrappers.close()
        if previous is not None:
            set_em_matmul_precision(previous)
    return _numbers(driver, samples, cell.spec['limits'])


def control(cell, seed, calls, torch, device):
    """{number: value} with the reference, in TF32, in the program's
    place (drivers that have such a control), from the same inputs."""
    driver = _driver(cell, seed, torch, device)
    if not hasattr(driver, 'control'):
        raise runner.Failure(2, f'{cell.name}: its driver has no reference '
                                'control; the program_tf32 kind is its control')
    samples = [(i, driver.control(i)) for i in range(calls)]
    return _numbers(driver, samples, cell.spec['limits'])


__all__ = ['program', 'control']
