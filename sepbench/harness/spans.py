"""Wrappers around the program's functions, installed by dotted name.

A layer file (``sepbench/layers/<span>.json``) names the functions a
layer is entered through, where its callers look them up (a module
attribute such as ``pb_bss_tpu_torch.pipeline.stft``, or a method such
as ``pb_bss_tpu_torch.permutation_alignment.DHTVPermutationAlignment
.calculate_mapping``). In a traced run each call of them runs inside a
``torch.profiler.record_function`` range named ``sepbench.<span>``, and
its host seconds are kept; the reduction of the trace attributes the
kernels launched inside the range to it. No synchronization is added.
"""
from __future__ import annotations

import collections
import functools
import importlib
import time


def resolve(dotted):
    """(owner, attribute) of a dotted name: the longest importable
    module prefix, then attributes."""
    parts = dotted.split('.')
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module('.'.join(parts[:cut]))
        except ImportError:
            continue
        for name in parts[cut:-1]:
            owner = getattr(owner, name)
        if not hasattr(owner, parts[-1]):
            raise AttributeError(f'{dotted}: no attribute {parts[-1]!r}')
        return owner, parts[-1]
    raise ImportError(f'no module in {dotted!r}')


class Wrappers:
    """A stack of installed wrappers, removed in reverse order."""

    def __init__(self):
        self._undo = []
        # host seconds of each span's calls, by span name
        self.host_times = collections.defaultdict(list)

    def wrap(self, dotted, make):
        """Replace ``dotted`` by ``make(original)``."""
        owner, attr = resolve(dotted)
        original = (owner.__dict__[attr] if isinstance(owner, type)
                    else getattr(owner, attr))
        wrapped = functools.wraps(original)(make(original))
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, original))

    def span(self, dotted, name):
        import torch

        times = self.host_times[name]

        def make(original):
            def spanned(*args, **kwargs):
                start = time.perf_counter()
                with torch.profiler.record_function(f'sepbench.{name}'):
                    result = original(*args, **kwargs)
                times.append(time.perf_counter() - start)
                return result
            return spanned
        self.wrap(dotted, make)

    def close(self):
        while self._undo:
            owner, attr, original = self._undo.pop()
            setattr(owner, attr, original)


def install_layers(wrappers, layers):
    """Span every target of every layer: {span: layer dict}."""
    for span, layer in layers.items():
        for target in layer['targets']:
            wrappers.span(target, span)


__all__ = ['resolve', 'Wrappers', 'install_layers']
