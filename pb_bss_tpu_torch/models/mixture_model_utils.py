"""Shared mixture-model math: E-step posteriors and mixture weights
(counterpart of ``pb_bss_tpu.models.mixture_model_utils``)."""
from __future__ import annotations

import itertools
import math

import torch

from .._dtypes import tiny as _tiny
from .._shard import (
    FREQUENCY_AXIS,
    frequency_gather,
    frequency_rows,
    sharded_count,
    sharded_sum,
    spans_shard,
)

__all__ = ['log_pdf_to_affiliation',
           'log_pdf_to_affiliation_for_integration_models_with_inline_pa',
           'estimate_mixture_weight', 'apply_inline_permutation_alignment']


def log_pdf_to_affiliation(weight, log_pdf, source_activity_mask=None,
                           affiliation_eps=0.):
    """Posterior responsibilities from per-class log densities.

    Max-shifted exponentiation, weight multiplication in the linear
    domain, optional boolean source-activity gating, tiny-clamped
    normalization, optional ``[eps, 1 - eps]`` clipping (no
    re-normalization afterwards).

    Args:
        weight: broadcastable against log_pdf, e.g. (..., K, 1).
        log_pdf: (..., K, N)
        source_activity_mask: optional bool (..., K, N)
    """
    affiliation = torch.exp(
        log_pdf - log_pdf.max(dim=-2, keepdim=True).values)
    affiliation = affiliation * weight
    if source_activity_mask is not None:
        affiliation = affiliation * source_activity_mask
    denominator = torch.clamp(
        affiliation.sum(-2, keepdim=True), min=_tiny(affiliation))
    affiliation = affiliation / denominator
    if affiliation_eps != 0:
        affiliation = torch.clamp(
            affiliation, affiliation_eps, 1 - affiliation_eps)
    return affiliation


def log_pdf_to_affiliation_for_integration_models_with_inline_pa(
        weight, spatial_log_pdf, spectral_log_pdf, source_activity_mask=None,
        affiliation_eps=0.):
    """Inline per-frequency permutation alignment between a spatial and a
    spectral model ([Drude2018Dual] Eq. 11-12): per frequency the spatial
    classes are permuted to the permutation whose posterior best explains
    the joint log-pdf, ``argmax_P sum_{k,t} gamma_P log p_P``.

    All K! permutations are evaluated at once as one gather, (P, F, K, T)
    candidate log-pdfs -> auxiliary values (P, F) -> argmax over P per
    frequency (the first of equal maxima). K is asserted small (K! terms).

    Shapes: spatial_log_pdf / spectral_log_pdf (F, K, T); weight
    broadcastable against them.
    """
    F, num_classes, T = spatial_log_pdf.shape
    assert num_classes <= 6, (num_classes, 'K! blows up')
    permutations = torch.tensor(
        list(itertools.permutations(range(num_classes))),
        device=spatial_log_pdf.device)  # (P, K)
    # (P, F, K, T): spatial rows permuted, spectral fixed
    log_pdf = spatial_log_pdf[:, permutations, :].transpose(0, 1) \
        + spectral_log_pdf[None]
    candidate = torch.exp(log_pdf - log_pdf.max(dim=-2, keepdim=True).values)
    candidate = candidate / torch.clamp(candidate.sum(-2, keepdim=True),
                                        min=_tiny(candidate))
    auxiliary = (candidate * log_pdf).sum((-2, -1))  # (P, F)
    best = torch.argmax(auxiliary, dim=0)  # (F,)
    best_log_pdf = log_pdf[best, torch.arange(F, device=best.device)]
    return log_pdf_to_affiliation(
        torch.broadcast_to(torch.as_tensor(weight), spatial_log_pdf.shape),
        best_log_pdf, source_activity_mask=source_activity_mask,
        affiliation_eps=affiliation_eps)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def mixture_weight_axis(weight_constant_axis, ndim, axis=FREQUENCY_AXIS):
    """The axis of a mixture weight fitted with ``weight_constant_axis``
    on ``ndim``-dim (..., F, K, T) affiliations that holds their
    ``axis`` (keepdims: ``axis`` itself; -3 the bins, or an utterance
    axis left of them), or None when the weight is constant over it, or
    global: the integer class axis's (K, 1) of
    :func:`estimate_mixture_weight` (a tuple with the class axis keeps
    the bins: (..., F, 1, T|1))."""
    if isinstance(weight_constant_axis, int) \
            and weight_constant_axis % ndim == ndim - 2:
        return None
    axes = {a % ndim for a in _axes(weight_constant_axis)}
    return None if axis % ndim in axes else axis


def estimate_mixture_weight(affiliation, saliency=None,
                            weight_constant_axis=-1,
                            dirichlet_prior_concentration=1):
    """M-step mixture weight with ``weight_constant_axis`` semantics:
    an axis resolving to -2 (the class axis) fixes the weights to 1/K
    with shape (K, 1); otherwise the (saliency-weighted, then
    L1-normalized over classes) mean over the given axes, keepdims.

    Without saliency, ``dirichlet_prior_concentration`` alpha > 1 takes
    the MAP estimate under a symmetric Dirichlet prior, per-bin weights
    only: ``(sum_t gamma + alpha - 1) / (T + (alpha - 1) K)``; ``inf``
    gives 1/K of shape (..., K, 1); the default 1 is the plain mean.
    """
    if isinstance(weight_constant_axis, int) and \
            weight_constant_axis % affiliation.ndim - affiliation.ndim == -2:
        K = affiliation.shape[-2]
        return torch.full((K, 1), 1. / K, dtype=affiliation.dtype,
                          device=affiliation.device)
    axes = _axes(weight_constant_axis)
    if saliency is None:
        if dirichlet_prior_concentration == 1:
            if not spans_shard(axes, affiliation.ndim):
                return affiliation.mean(dim=axes, keepdim=True)
            # over every bin (and utterance) of a sharded fit
            return sharded_sum(
                affiliation.sum(dim=axes, keepdim=True), axes,
                affiliation.ndim) / sharded_count(affiliation.shape, axes)
        *independent, K, T = affiliation.shape
        if math.isinf(dirichlet_prior_concentration) \
                and dirichlet_prior_concentration > 0:
            return torch.full((*independent, K, 1), 1. / K,
                              dtype=affiliation.dtype,
                              device=affiliation.device)
        assert dirichlet_prior_concentration >= 1, \
            dirichlet_prior_concentration
        assert weight_constant_axis in ((-1,), -1), weight_constant_axis
        return (affiliation.sum(-1, keepdim=True)
                + (dirichlet_prior_concentration - 1)) / (
            T + (dirichlet_prior_concentration - 1) * K)
    masked = (affiliation * saliency[..., None, :]).sum(
        dim=axes, keepdim=True)
    masked = sharded_sum(masked, axes, affiliation.ndim)
    norm = masked.abs().sum(-2, keepdim=True)
    norm = torch.where(norm == 0, torch.full_like(norm, 1e-10), norm)
    return masked / norm


def apply_inline_permutation_alignment(affiliation, *, quadratic_form=None,
                                       weight_constant_axis, aligner):
    """Run a permutation aligner inside the EM loop: the mapping of the
    (F, K, T) posterior permutes the posterior (and the quadratic form)
    along the class axis before the M-step.

    affiliation: (F, K, T); the aligner works on (K, F, T).
    """
    assert affiliation.ndim == 3, (
        'Inline permutation alignment requires (F, K, T) affiliations, '
        f'got {tuple(affiliation.shape)}.'
    )
    assert weight_constant_axis in ((-3,), (-3, -1), -3), (
        'Inline permutation alignment exists to reduce the mismatch '
        'between frequency-INDEPENDENT mixture weights and the '
        'per-frequency observation model, so it requires a '
        'frequency-constant weight_constant_axis ((-3,) or (-3, -1)); '
        f'got {weight_constant_axis}. With per-bin weights the model '
        'is invariant under per-bin class relabeling — fit without '
        'the inline aligner and align the result instead (reference '
        'mixture_model_utils.py:264-306 enforces the same).'
    )
    a_kft = affiliation.transpose(0, 1)
    # the aligner walks every bin (gathered in a sharded fit)
    mapping = frequency_rows(
        aligner.calculate_mapping(frequency_gather(a_kft, 1)), 1)
    affiliation = aligner.apply_mapping(a_kft, mapping).transpose(0, 1)
    if quadratic_form is None:
        return affiliation
    quadratic_form = aligner.apply_mapping(
        quadratic_form.transpose(0, 1), mapping).transpose(0, 1)
    return affiliation, quadratic_form
