"""Block-online (streaming) cACGMM (counterpart of
``pb_bss_tpu.models.cacgmm_streaming``).

Recursive EM over time blocks with exponential forgetting of the
sufficient statistics: the cACG M-step is a function of the
affiliation-weighted, quadratic-form-normalized scatter
``S_k = sum_t gamma_kt y_t y_t^H / q_kt`` and the affiliation counts
``N_k = sum_t gamma_kt``, so a decayed running (S, N) pair is a
sufficient state. Per block:

    gamma, q  <- E-step of the incoming block under the current model
    S <- rho * S + S_block,   N <- rho * N + N_block
    model <- M-step from (S, N)      (x inner_iterations)

``rho = forgetting ** t_block`` discounts per *frame*, so quality is
block-size-invariant; ``forgetting=1`` is exact incremental EM.

On the card the stream's kernels are the JAX package's: the warm-up fit
(:meth:`StreamingCACGMM.init_state`, ``CACGMMTrainer.fit_predict_model``)
is one launch of the whole-fit EM kernel K2 when the warm-up block is
inside its gate (:func:`pb_bss_tpu_torch.ops.em_loop.fits`), and every
M-step's eigendecomposition is one launch of the batched Jacobi kernel
K1 (``ComplexAngularCentralGaussian.from_covariance`` on (F, K, D, D)).
The block E-step and scatter are PyTorch einsums under
:func:`~pb_bss_tpu_torch.models._precision.full_fp32`, as the JAX package
leaves them to XLA. The JAX package runs ``fit_predict_stream`` as one
``lax.scan``; here it is the loop of :meth:`StreamingCACGMM.update`.
"""
from __future__ import annotations

import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from ._precision import full_fp32
from .base import Model, force_hermitian, modelclass
from .cacgmm import CACGMM, CACGMMTrainer
from .complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
    normalize_observation,
)

__all__ = ['StreamingCACGMM', 'StreamingCACGMMState']


@modelclass
class StreamingCACGMMState(Model):
    """Carry of the streaming fit: the current model and the decayed
    statistics (the JAX package's dict schema).

    Attributes:
        model: the current :class:`CACGMM`.
        scatter: (..., K, D, D) decayed weighted scatter
            ``sum rho^age * gamma / q * y y^H``.
        count: (..., K) decayed affiliation counts.
        frames: (...,) decayed total frame count (the weight
            normalizer).
    """
    model: CACGMM = None
    scatter: torch.Tensor = None
    count: torch.Tensor = None
    frames: torch.Tensor = None


def _block_stats(model, y_block, *, affiliation_eps):
    """E-step and M-statistics of one (..., D, Tb) block: (affiliation
    (..., K, Tb), scatter (..., K, D, D), count (..., K))."""
    affiliation, quadratic_form, _ = model._predict(
        y_block, affiliation_eps=affiliation_eps)
    w = affiliation / torch.clamp(quadratic_form,
                                  min=10 * _tiny(quadratic_form))
    yw = y_block[..., None, :, :] * w[..., None, :].to(y_block.dtype)
    with full_fp32():
        scatter = yw @ y_block.conj().transpose(-1, -2)[..., None, :, :]
    return affiliation, scatter, affiliation.sum(-1)


def _model_from_stats(scatter, count, frames, *, eigenvalue_floor,
                      eigh_sweeps):
    """The M-step from decayed statistics (K1 on the card)."""
    D = scatter.shape[-1]
    covariance = D * scatter / torch.clamp(
        count, min=_tiny(count))[..., None, None].to(scatter.dtype)
    cacg = ComplexAngularCentralGaussian.from_covariance(
        force_hermitian(covariance), eigenvalue_floor=eigenvalue_floor,
        covariance_norm='eigenvalue', eigh_sweeps=eigh_sweeps)
    weight = (count / torch.clamp(frames, min=_tiny(count))[..., None]
              )[..., None]
    return CACGMM(weight=weight, cacg=cacg)


def _update_block(state, y_block, *, inner_iterations, forgetting,
                  affiliation_eps, eigenvalue_floor, eigh_sweeps):
    """One streaming step: blend the (..., D, Tb) block into the decayed
    statistics.

    Inner iterations re-run the E-step of the SAME block under the
    refined model, re-blending against the pre-block statistics each
    time (the block is never double-counted). Returns (state,
    affiliation of the last E-step).
    """
    t_block = y_block.shape[-1]
    rho = forgetting ** t_block  # per-frame discount, block-invariant
    model = state.model
    affiliation = None
    scatter, count, frames = state.scatter, state.count, state.frames
    for _ in range(inner_iterations):
        affiliation, s_b, n_b = _block_stats(
            model, y_block, affiliation_eps=affiliation_eps)
        scatter = rho * state.scatter + s_b
        count = rho * state.count + n_b
        frames = rho * state.frames + t_block
        model = _model_from_stats(
            scatter, count, frames, eigenvalue_floor=eigenvalue_floor,
            eigh_sweeps=eigh_sweeps)
    return StreamingCACGMMState(model=model, scatter=scatter, count=count,
                                frames=frames), affiliation


class StreamingCACGMM:
    """Block-online cACGMM for serving.

    Usage::

        stream = StreamingCACGMM(num_classes=3, forgetting=0.9995)
        state = None
        for block in audio_stft_blocks:       # (F, T_block, D) each
            state, affiliation = stream.update(state, block)

    or, offline::

        model, affiliation = stream.fit_predict_stream(y, t_block=64)

    Args:
        num_classes: K mixture components.
        forgetting: per-FRAME statistics discount in (0, 1]; 1.0 is
            exact incremental EM, smaller values track moving sources
            (memory ``1 / (1 - forgetting)`` frames).
        inner_iterations: EM refinements per block (statistics are
            re-blended, never double-counted).
        init_iterations: offline EM iterations on the FIRST block.
        affiliation_eps / eigenvalue_floor / eigh_sweeps: the numeric
            guards of :class:`CACGMMTrainer`, same semantics.
    """

    def __init__(self, num_classes, *, forgetting=1.0, inner_iterations=1,
                 init_iterations=10, affiliation_eps=1e-10,
                 eigenvalue_floor=1e-10, eigh_sweeps=None):
        assert 0.0 < forgetting <= 1.0, forgetting
        self.num_classes = num_classes
        self.forgetting = float(forgetting)
        self.inner_iterations = int(inner_iterations)
        self.init_iterations = int(init_iterations)
        self.affiliation_eps = affiliation_eps
        self.eigenvalue_floor = eigenvalue_floor
        self.eigh_sweeps = eigh_sweeps

    def init_state(self, y_block, *, generator=None):
        """Warm-start the stream: offline EM on the first block, whose
        statistics become the initial decayed statistics.

        Args:
            y_block: (..., T_block, D) complex first block.
            generator: ``torch.Generator`` of the EM's random
                initialization (default: one seeded 0 on the block's
                device).
        Returns:
            (state, affiliation (..., K, T_block)).
        """
        model, affiliation = CACGMMTrainer().fit_predict_model(
            y_block, num_classes=self.num_classes,
            iterations=self.init_iterations, generator=generator,
            affiliation_eps=self.affiliation_eps,
            eigenvalue_floor=self.eigenvalue_floor,
            eigh_sweeps=self.eigh_sweeps)
        state = self._state_from_first_block(
            model, normalize_observation(y_block))
        return state, affiliation

    def _state_from_first_block(self, model, y_tl):
        """The stream state of a fitted model on its (..., D, T) first
        block."""
        _, scatter, count = _block_stats(
            model, y_tl, affiliation_eps=self.affiliation_eps)
        frames = torch.full(y_tl.shape[:-2], float(y_tl.shape[-1]),
                            dtype=_real_dtype(y_tl), device=y_tl.device)
        return StreamingCACGMMState(model=model, scatter=scatter,
                                    count=count, frames=frames)

    def update(self, state, y_block, *, generator=None):
        """Consume one (..., T_block, D) block; returns ``(state,
        affiliation)`` with affiliation (..., K, T_block). ``state=None``
        starts the stream (offline warm start on this block)."""
        if state is None:
            return self.init_state(y_block, generator=generator)
        return _update_block(
            state, normalize_observation(y_block),
            inner_iterations=self.inner_iterations,
            forgetting=self.forgetting,
            affiliation_eps=self.affiliation_eps,
            eigenvalue_floor=self.eigenvalue_floor,
            eigh_sweeps=self.eigh_sweeps)

    def fit_predict_stream(self, y, *, t_block=64, generator=None):
        """Run the whole stream: the first block fit offline, the rest
        through :meth:`update`, block by block.

        Args:
            y: (..., T, D) complex observations; T is truncated to a
                multiple of ``t_block`` (streaming has no lookahead).
        Returns:
            (final model, affiliation (..., K, T_used)).
        """
        T = y.shape[-2]
        nb = T // t_block
        assert nb >= 1, (T, t_block)
        state = None
        affiliations = []
        for i in range(nb):
            state, affiliation = self.update(
                state, y[..., i * t_block:(i + 1) * t_block, :],
                generator=generator)
            affiliations.append(affiliation)
        return state.model, torch.cat(affiliations, dim=-1)
