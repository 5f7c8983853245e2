"""Iterative phase reconstruction: Griffin-Lim and MISI.

Counterpart of ``pb_bss_tpu.transform.griffin_lim_module``: each
``step`` is an stft -> magnitude projection -> istft round trip on the
port's :mod:`.stft_module`, on the device of the given STFT. The
functional forms run the iterations as a plain loop.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .stft_module import istft, stft

__all__ = ['GriffinLim', 'MISI', 'griffin_lim', 'misi']


def _project(magnitude, X):
    """``magnitude`` with the phase of ``X``."""
    return magnitude * torch.exp(1j * torch.angle(X))


class GriffinLim:
    """[Griffin1984GriffinLim] signal estimation from modified STFT.

    Args:
        X: (K, T, F) complex STFT (its phases are discarded).
        y: (num_samples,) mixture (needed by MISI / first_guess='y').
        first_guess: 'istft' | 'white_gaussian_noise' | 'y'.
        generator: the ``torch.Generator`` that draws the white Gaussian
            first guess (a fresh one seeded with 0 if None), on the
            device of ``X``.
    """

    def __init__(self, X, y=None, first_guess='istft',
                 size=512, shift=128, fading=False, generator=None):
        self.size = size
        self.shift = shift
        self.fading = fading
        self.stft = partial(stft, size=size, shift=shift, fading=fading)
        self.istft = partial(
            istft, size=size, shift=shift, fading=fading)

        self.X = torch.as_tensor(X)
        self.X_dash_dash = self.X
        self.X_dash = self.X
        self.y = None if y is None else torch.as_tensor(
            y, device=self.X.device)

        if first_guess == 'istft':
            self.x_hat = self.istft(self.X)
        elif first_guess == 'white_gaussian_noise':
            like = self.istft(self.X)
            if generator is None:
                generator = torch.Generator(self.X.device).manual_seed(0)
            self.x_hat = torch.randn(like.shape, dtype=like.dtype,
                                     device=like.device,
                                     generator=generator)
        elif first_guess == 'y':
            K = self.X.shape[0]
            # Text just under [Gunawan2010MISI] Equation 5
            self.x_hat = (self.y[None, :] / K).repeat(K, 1)
        else:
            raise ValueError(first_guess)

    def step(self):
        self.X_dash_dash = self.stft(self.x_hat)
        self.X_dash = _project(self.X.abs(), self.X_dash_dash)
        self.x_hat = self.istft(self.X_dash)

    def evaluate(self, speech_source):
        """Consistency + mir_eval metrics against the oracle sources,
        on the device of the estimate."""
        from .. import evaluation
        from ..evaluation.sxr_module import (
            get_variance_for_zero_mean_signal,
        )
        metrics = evaluation.OutputMetrics(
            speech_prediction=self.x_hat,
            speech_source=speech_source,
            enable_si_sdr=True,
            device=self.x_hat.device,
        )
        inconsistency = self.X_dash - self.stft(self.istft(self.X_dash))
        return dict(
            mir_eval_sdr=float(np.mean(metrics.mir_eval['sdr'])),
            mir_eval_sir=float(np.mean(metrics.mir_eval['sir'])),
            inconsistency=float(get_variance_for_zero_mean_signal(
                inconsistency.cpu().numpy())),
        )


class MISI(GriffinLim):
    """[Gunawan2010MISI]: distribute the mixture residual across the
    sources before each magnitude projection."""

    def _mixture(self):
        # The iSTFT round trip may pad the estimates beyond len(y);
        # align by zero-padding y.
        return torch.nn.functional.pad(
            self.y, (0, self.x_hat.shape[-1] - self.y.shape[-1]))

    def step(self):
        K = self.X.shape[0]
        # [Gunawan2010MISI] Equation 5
        e = self._mixture() - self.x_hat.sum(0)
        # [Gunawan2010MISI] Equation 4
        x_dash_dash = self.x_hat + e / K
        self.X_dash_dash = self.stft(x_dash_dash)
        # [Gunawan2010MISI] Equation 3
        self.X_dash = _project(self.X.abs(), self.X_dash_dash)
        # [Gunawan2010MISI] Equation 2
        self.x_hat = self.istft(self.X_dash)


def griffin_lim(X, iterations=20, **kwargs):
    """Functional Griffin-Lim: the class trajectory, ``iterations``
    steps from the first guess."""
    gl = GriffinLim(X, **kwargs)
    for _ in range(iterations):
        gl.step()
    return gl.x_hat


def misi(X, y, iterations=20, **kwargs):
    """Functional MISI: the reconstructed source signals."""
    m = MISI(X, y=y, first_guess='y', **kwargs)
    for _ in range(iterations):
        m.step()
    return m.x_hat
