"""The work of the FCA refinement, counted from shapes: the least it
needs whatever implements it.

An iteration of the fit over F' bins (the batch folded into the bins),
T frames, D channels and K classes, a frame:

* the D rows of the diagonalizer's IP sweep each need a weighted
  covariance ``V_d = mean_t y y^H / sigma2_d``. These are Hermitian, and
  the outer product ``y y^H`` is the same for every row: its D(D+1)/2
  entries on and above the diagonal, one complex product each (6
  operations), then for each of the D rows a real weight times each
  entry, added (4 operations): ``D(D+1)/2 (6 + 4 D)``;
* the transform ``Q y`` for the powers, D^2 complex multiply-adds (8
  operations each): ``8 D^2``;
* the MUs of the powers and the spatial spectra: ``16 K D``.

The back-transform: ``Q y`` again and the K images at the reference
channel, ``8 D^2 + 8 K D`` a frame. Bytes: the complex64 observations
read twice an iteration (for the powers and for the IP rows) and once
more for the back-transform, and the K output spectra (complex64)
written once.
"""
from __future__ import annotations

from . import counts


def fca_work(config, batch):
    """(flops, bytes) of the refinement of one batch."""
    D, K = config['channels'], config['num_classes']
    iterations = config['refine_iterations']
    n = batch * (config['stft_size'] // 2 + 1)
    T = counts.frames(config)
    covariances = D * (D + 1) // 2 * (6 + 4 * D)
    iteration = covariances + 8 * D ** 2 + 16 * K * D
    back_transform = 8 * D ** 2 + 8 * K * D
    flops = n * T * (iterations * iteration + back_transform)
    observations = n * T * D * 8
    moved = (2 * iterations + 1) * observations + n * K * T * 8
    return flops, moved


def fca_bound_ms(config, batch):
    """The least ms the card could take for the refinement of one
    batch (``counts.bound``: the larger of its two times)."""
    flops, moved = fca_work(config, batch)
    return counts.bound(moved, flops)[0]


__all__ = ['fca_work', 'fca_bound_ms']
