"""BSS-Eval with the STOI of its selection, on the device, with one
device-to-host copy.

Counterpart of ``pb_bss_tpu.evaluation._fused_eval_device``. The output
facades need BSS-Eval (whose permutation ``selection`` aligns every
other metric) and STOI on the selected estimates. Here one pass computes
the BSS-Eval criteria, gathers the selected estimates on the device,
scores STOI on the aligned pairs and copies all five results to the
host as one (B, 5, K) array. The per-metric math is
:mod:`.module_bss_eval_device`'s and :mod:`.module_stoi_device`'s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from .module_bss_eval_device import _bss_eval_core, _check_shapes, _inputs
from .module_stoi_device import _stoi

__all__ = ['bss_eval_stoi_fused', 'bss_eval_stoi_fused_batch']

_KEYS = ('sdr', 'sir', 'sar', 'selection', 'stoi')


def _evaluate(refs, ests, sample_rate, compute_permutation):
    """(B, K, N), (B, M, N) -> (B, 5, K) rows sdr, sir, sar, selection,
    stoi."""
    sdr, sir, sar, sel = _bss_eval_core(
        refs, ests, flen=512, compute_permutation=compute_permutation)
    selected = ests.gather(1, sel[..., None].expand(-1, -1, ests.shape[-1]))
    st = _stoi(refs, selected, sample_rate)
    return torch.stack([sdr, sir, sar, sel.to(sdr.dtype), st], 1)


@profiling.span('score')
def bss_eval_stoi_fused_batch(reference, estimation, sample_rate,
                              compute_permutation=True, device='cuda'):
    """BSS-Eval + selection-aligned STOI of (..., K, N) references
    against (..., M, N) estimates (M in {K, K+1}) in one pass on
    ``device`` ('cuda' by default; raises without CUDA) and one
    device-to-host copy.

    Returns:
        dict of (..., K) numpy arrays: 'sdr', 'sir', 'sar', 'stoi'
        (float) and 'selection' (int64).
    """
    refs, ests = _inputs(reference, estimation, device)
    K, M, n = _check_shapes(refs, ests, compute_permutation)
    lead = tuple(refs.shape[:-2])
    packed = _evaluate(refs.reshape(-1, K, n), ests.reshape(-1, M, n),
                       int(sample_rate), bool(compute_permutation))
    with profiling.span('score.read'):
        packed = packed.cpu().numpy()
    out = {key: packed[:, i].reshape(lead + (K,))
           for i, key in enumerate(_KEYS)}
    out['selection'] = np.rint(out['selection']).astype(np.int64)
    return out


def bss_eval_stoi_fused(reference, estimation, sample_rate,
                        compute_permutation=True, device='cuda'):
    """:func:`bss_eval_stoi_fused_batch` of one utterance: (K, N)
    references against (M, N) estimates -> dict of (K,) arrays."""
    reference = torch.as_tensor(reference)
    estimation = torch.as_tensor(estimation)
    assert reference.ndim == 2 and estimation.ndim == 2, (
        reference.shape, estimation.shape)
    out = bss_eval_stoi_fused_batch(
        reference[None], estimation[None], sample_rate,
        compute_permutation=compute_permutation, device=device)
    return {key: value[0] for key, value in out.items()}
