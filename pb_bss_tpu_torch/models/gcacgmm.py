"""Gaussian x complex-Angular-Central-Gaussian integration model.

Counterpart of ``pb_bss_tpu.models.gcacgmm``: a joint spatial (cACG on
the multichannel observation, per frequency bin) and spectral (Gaussian
on the Deep-Clustering embedding, global over the (F*T) frames of an
utterance) mixture [Drude2019 Integration], with the weighted log-pdf
combination (``spatial_weight`` / ``spectral_weight``), the optional
per-frequency inline permutation alignment over the K! permutations,
every ``weight_constant_axis`` and ``fixed_covariance``.

The fit takes one of three routes, chosen by
:func:`pb_bss_tpu_torch.models.vmfcacgmm._resolve_fused_mode` as the JAX
package chooses them (see ``models/vmfcacgmm.py`` for the gates):

1. **scan**: the plain EM loop (the E-step :meth:`GCACGMM._predict`,
   then the Gaussian and cACG M-steps); on the card the cACG eigh is the
   batched Jacobi K1.
2. **'step'** (``'auto'`` on the card for 'spherical' / 'diagonal'
   covariances): one statistics pass of K10
   (:func:`pb_bss_tpu_torch.ops.integration_em.e_stats`) per iteration
   after the first, then the Gaussian moment finish and
   ``from_covariance`` (K1) in PyTorch.
3. **'loop'** (opt-in): the whole fit in one cooperative launch of K12
   (:func:`pb_bss_tpu_torch.ops.integration_em_loop.integration_em_full`),
   then the Gaussian finish of its last accumulators.
"""
from __future__ import annotations

import math
from operator import xor
from typing import Any

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from .._shard import frequency_sum, spans_frequency
from ..ops import integration_em, integration_em_loop
from .base import Model, modelclass
from .complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
)
from .gaussian import (
    DiagonalGaussian,
    Gaussian,
    GaussianTrainer,
    SphericalGaussian,
)
from .mixture_model_utils import (
    log_pdf_to_affiliation,
    log_pdf_to_affiliation_for_integration_models_with_inline_pa,
)

__all__ = ['GCACGMM', 'GCACGMMTrainer']


def unsqueeze(x, axis):
    """Insert singleton dimensions at the (possibly negative) positions."""
    x = torch.as_tensor(x)
    shape = list(x.shape)
    future_ndim = len(shape) + len(axis)
    for p in sorted(a % future_ndim for a in axis):
        shape.insert(p, 1)
    return x.reshape(shape)


def normalize_rows(x):
    """x / max(|x|, tiny) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=_tiny(x))


def integration_predict(model, spectral, observation, embedding,
                        affiliation_eps=0., inline_permutation_alignment=False):
    """The E-step of an integration model: (affiliation (..., F, K, T),
    quadratic form (..., F, K, T)) of unit-norm (..., F, T, D)
    observations and (..., F, T, E) embeddings under the model's cACG
    and its global spectral model ``spectral`` (vMF or Gaussian)."""
    *batch, F, T, D = observation.shape
    E = embedding.shape[-1]
    cacg_log_pdf, quadratic_form = model.cacg._log_pdf(
        observation[..., None, :, :].transpose(-1, -2))
    # the spectral model is global over (F*T) per utterance; leading
    # batch axes carry their own spectral state
    spectral_log_pdf = spectral.log_pdf(
        embedding.reshape(*batch, 1, F * T, E))
    K = spectral_log_pdf.shape[-2]
    spectral_log_pdf = spectral_log_pdf.reshape(
        *batch, K, F, T).movedim(-3, -2)
    weight = unsqueeze(model.weight, model.weight_constant_axis)
    if inline_permutation_alignment:
        affiliation = \
            log_pdf_to_affiliation_for_integration_models_with_inline_pa(
                weight=weight,
                spatial_log_pdf=model.spatial_weight * cacg_log_pdf,
                spectral_log_pdf=model.spectral_weight * spectral_log_pdf,
                affiliation_eps=affiliation_eps)
    else:
        affiliation = log_pdf_to_affiliation(
            weight, model.spatial_weight * cacg_log_pdf
            + model.spectral_weight * spectral_log_pdf,
            affiliation_eps=affiliation_eps)
    return affiliation, quadratic_form


@modelclass
class GCACGMM(Model):
    weight: torch.Tensor = None  # () / (K,) / (F, K) / (K, T)
    gaussian: Any = None  # Gaussian / DiagonalGaussian / SphericalGaussian
    cacg: ComplexAngularCentralGaussian = None
    weight_constant_axis: tuple = (-1,)
    spatial_weight: float = 1.
    spectral_weight: float = 1.

    @classmethod
    def from_dict(cls, d):
        """Restores the polymorphic ``gaussian`` field too: the variant is
        identified by the covariance's rank relative to the mean (full
        D x D, diagonal D, spherical scalar)."""
        model = super().from_dict(d)
        g = model.gaussian
        if isinstance(g, dict) and g.get('covariance') is not None:
            rank = np.ndim(g['covariance']) - np.ndim(g['mean'])
            if rank == 1:
                gaussian_cls = Gaussian
            elif rank == 0:
                gaussian_cls = DiagonalGaussian
            else:
                gaussian_cls = SphericalGaussian
            model = GCACGMM(
                weight=model.weight, gaussian=gaussian_cls.from_dict(g),
                cacg=model.cacg,
                weight_constant_axis=tuple(model.weight_constant_axis),
                spatial_weight=float(model.spatial_weight),
                spectral_weight=float(model.spectral_weight))
        return model

    def predict(self, observation, embedding):
        """observation: (..., F, T, D) complex; embedding: (..., F, T, E)
        real. Returns the affiliation (..., F, K, T)."""
        assert observation.is_complex(), observation.dtype
        assert not embedding.is_complex(), embedding.dtype
        return self._predict(normalize_rows(observation), embedding)[0]

    def _predict(self, observation, embedding, affiliation_eps=0.,
                 inline_permutation_alignment=False):
        return integration_predict(
            self, self.gaussian, observation, embedding,
            affiliation_eps=affiliation_eps,
            inline_permutation_alignment=inline_permutation_alignment)


def _integration_weight(masked_affiliation, weight_constant_axis):
    """Weight M-step of the integration models: sum over the constant
    axes, normalize over classes, squeeze the constant axes (an axis
    holding -2, the classes, gives the fixed 1/K)."""
    K = masked_affiliation.shape[-2]
    if -2 in weight_constant_axis:
        return torch.tensor(1.0 / K, dtype=masked_affiliation.dtype,
                            device=masked_affiliation.device)
    weight = masked_affiliation.sum(weight_constant_axis, keepdim=True)
    if spans_frequency(weight_constant_axis, masked_affiliation.ndim):
        weight = frequency_sum(weight)  # over every bin of a sharded fit
    weight = weight / weight.sum(-2, keepdim=True)
    for axis in sorted((a % weight.ndim for a in weight_constant_axis),
                       reverse=True):
        weight = weight.squeeze(axis)
    return weight


def _initialization(observation, num_classes, generator):
    """A random (..., F, K, T) affiliation normalized over classes."""
    *batch, F, T, _ = observation.shape
    if generator is None:
        generator = torch.Generator(
            device=observation.device).manual_seed(0)
    init = torch.rand((*batch, F, num_classes, T), generator=generator,
                      dtype=_real_dtype(observation),
                      device=observation.device)
    return init / init.sum(-2, keepdim=True)


def _check_inputs(observation, embedding, inline_permutation_alignment):
    assert observation.is_complex(), observation.dtype
    assert not embedding.is_complex(), embedding.dtype
    assert observation.shape[-1] > 1
    # a (F, D, T) layout mistake puts T in the channel slot
    assert observation.shape[-1] < 35, (
        f'Channels: {observation.shape[-1]}, sure?')
    assert not (observation.ndim > 3 and inline_permutation_alignment), (
        'inline permutation alignment needs (F, T, D) observations (no '
        'leading batch axes)', tuple(observation.shape))


class Fold:
    """The fused routes' layout: leading batch axes folded into the bin
    axis, observations and embeddings time-last, complex64 / float32."""

    def __init__(self, observation, embedding, saliency):
        *self.batch, self.F, self.T, self.D = observation.shape
        self.E = embedding.shape[-1]
        self.fold = math.prod(self.batch)
        N = self.fold * self.F
        self.y = observation.transpose(-1, -2).reshape(
            N, self.D, self.T).to(torch.complex64).contiguous()
        self.emb = embedding.transpose(-1, -2).reshape(
            N, self.E, self.T).to(torch.float32).contiguous()
        self.saliency = None if saliency is None else saliency.reshape(
            N, self.T).to(torch.float32)

    def to_bins(self, x):
        """(*batch, F, ...) -> (fold * F, ...)."""
        return x.reshape(self.fold * self.F, *x.shape[len(self.batch) + 1:])

    def from_bins(self, x):
        return x.reshape(*self.batch, self.F, *x.shape[1:])

    def utterances(self, x):
        """(*batch, K[, E]) -> (fold, K[, E])."""
        return x.reshape(self.fold, *x.shape[len(self.batch):])

    def batched(self, x):
        """(fold, ...) -> (*batch, ...)."""
        return x.reshape(*self.batch, *x.shape[1:])


def _pin_f32(cacg, weight):
    """The kernels compute in f32: the first M-step's model in c64 / f32."""
    return (ComplexAngularCentralGaussian(
        covariance_eigenvalues=cacg.covariance_eigenvalues.to(torch.float32),
        covariance_eigenvectors=cacg.covariance_eigenvectors.to(
            torch.complex64)), weight.to(torch.float32))


def _check_kernel_knobs(use_fused_em, weight_constant_axis,
                        inline_permutation_alignment, ndim):
    """The kernel routes take only per-bin weights, no inline aligner and
    (..., F, T, D) input with at most one batch axis: anything else would
    silently fit another model."""
    assert (weight_constant_axis in ((-1,), -1)
            and not inline_permutation_alignment and ndim in (3, 4)), (
        f'use_fused_em={use_fused_em!r} requires weight_constant_axis='
        '(-1,), no inline_permutation_alignment and (F, T, D) or '
        f'(B, F, T, D) input; got {weight_constant_axis=}, '
        f'{inline_permutation_alignment=}, ndim {ndim}')


class GCACGMMTrainer:
    def fit(self, observation, embedding, initialization=None,
            num_classes=None, iterations=100, saliency=None, *,
            generator=None, hermitize=True, covariance_norm='eigenvalue',
            eigenvalue_floor=1e-10, covariance_type='spherical',
            fixed_covariance=None, affiliation_eps=1e-10,
            weight_constant_axis=(-1,), spatial_weight=1., spectral_weight=1.,
            inline_permutation_alignment=False,
            use_fused_em='auto') -> GCACGMM:
        """EM on (..., F, T, D) observations + (..., F, T, E) embeddings.
        Leading batch axes fit independent models per utterance.

        ``weight_constant_axis`` semantics (the affiliation is (F, K, T)):
        (-3, -2, -1) scalar, (-3, -1) per class, (-1,) per (F, K), (-3,)
        per (K, T).

        Args:
            generator: ``torch.Generator`` of the random initialization
                (default: one seeded 0 on the observation's device).
            use_fused_em: 'auto' (K10 on the card for eligible input with
                'spherical' / 'diagonal' covariance), True / 'step' (K10,
                its plain twin on the CPU), 'loop' (K12), False (the scan).
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not both '
            'and not neither. Got initialization is None: '
            f'{initialization is None}, num_classes is None: '
            f'{num_classes is None}.')
        _check_inputs(observation, embedding, inline_permutation_alignment)
        observation = normalize_rows(observation)
        if initialization is None:
            initialization = _initialization(observation, num_classes,
                                             generator)
        # one real dtype for the scan's sums, as JAX promotes
        rdtype = torch.promote_types(_real_dtype(observation),
                                     embedding.dtype)
        embedding = embedding.to(rdtype)
        initialization = torch.as_tensor(
            initialization, device=observation.device).to(rdtype)
        if isinstance(weight_constant_axis, list):
            weight_constant_axis = tuple(weight_constant_axis)
        if fixed_covariance is not None:
            fixed_covariance = torch.as_tensor(fixed_covariance,
                                               device=observation.device)

        from .vmfcacgmm import (
            _fused_integration_eligible,
            _resolve_fused_mode,
            _whole_fit_integration_eligible,
        )
        K = initialization.shape[-2]
        vector_cov = covariance_type in ('spherical', 'diagonal')
        mode = _resolve_fused_mode(
            use_fused_em,
            vector_cov and _fused_integration_eligible(
                observation, embedding, K, saliency, weight_constant_axis,
                inline_permutation_alignment),
            vector_cov and fixed_covariance is None
            and _whole_fit_integration_eligible(
                observation, embedding, K, saliency, weight_constant_axis,
                inline_permutation_alignment, int(iterations),
                covariance_norm, bool(hermitize), 'gaussian'))
        if mode != 'off':
            _check_kernel_knobs(use_fused_em, weight_constant_axis,
                                inline_permutation_alignment,
                                observation.ndim)
            assert vector_cov, (
                f'use_fused_em={use_fused_em!r} takes the spherical or '
                f'diagonal covariance, got {covariance_type!r}')
        if mode == 'loop':
            # the whole-fit kernel has no saliency path and no fixed
            # covariance: running it would silently drop them
            assert saliency is None, (
                "use_fused_em='loop' does not support saliency; use 'step' "
                'or the scan path')
            assert fixed_covariance is None, (
                "use_fused_em='loop' does not support fixed_covariance")
        has_saliency = saliency is not None
        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        else:
            saliency = torch.as_tensor(saliency, device=observation.device)

        return _gcacgmm_fit_em(
            observation, embedding, initialization, saliency,
            fixed_covariance, iterations=int(iterations),
            hermitize=bool(hermitize), covariance_norm=covariance_norm,
            eigenvalue_floor=float(eigenvalue_floor),
            covariance_type=covariance_type,
            affiliation_eps=float(affiliation_eps),
            weight_constant_axis=weight_constant_axis,
            spatial_weight=float(spatial_weight),
            spectral_weight=float(spectral_weight),
            inline_permutation_alignment=bool(inline_permutation_alignment),
            use_fused_em=mode, has_saliency=has_saliency)

    def fit_predict(self, observation, embedding, initialization=None,
                    num_classes=None, iterations=100, saliency=None,
                    **kwargs):
        """Fit a model, then return the posterior affiliations."""
        model = self.fit(observation, embedding, initialization,
                         num_classes, iterations, saliency, **kwargs)
        return model.predict(observation, embedding)


def _gaussian_state(gaussian, spherical, E):
    """(P m, per-dimension precision P, const) of a vector-covariance
    Gaussian: the kernel's spectral state."""
    if spherical:
        prec = (1. / gaussian.covariance)[..., None].expand_as(gaussian.mean)
        ldpc = -0.5 * E * torch.log(gaussian.covariance)
    else:
        prec = 1. / gaussian.covariance
        ldpc = -0.5 * torch.log(gaussian.covariance).sum(-1)
    const = 0.5 * E * math.log(2 * math.pi) - ldpc \
        + 0.5 * (gaussian.mean ** 2 * prec).sum(-1)
    return prec * gaussian.mean, prec, const


def _gaussian_finish(r, n, m2, spherical):
    """Gaussian moment matching from the global zeroth / first / second
    moments: mean r / n, covariance E[e^2] - mean^2 floored at tiny
    (averaged over the dimensions when spherical)."""
    tiny = _tiny(r)
    denom = torch.clamp(n, min=tiny)[..., None]
    mean = r / denom
    centered = torch.clamp(m2 / denom - mean ** 2, min=tiny)
    return mean, centered.mean(-1) if spherical else centered


def _gcacgmm_fit_em(observation, embedding, affiliation, saliency,
                    fixed_covariance, *, iterations, hermitize,
                    covariance_norm, eigenvalue_floor, covariance_type,
                    affiliation_eps, weight_constant_axis, spatial_weight,
                    spectral_weight, inline_permutation_alignment,
                    use_fused_em='off', has_saliency=False):
    *batch, F, T, D = observation.shape
    E = embedding.shape[-1]
    K = affiliation.shape[-2]

    def model_of(weight, gaussian, cacg):
        return GCACGMM(weight=weight, gaussian=gaussian, cacg=cacg,
                       weight_constant_axis=weight_constant_axis,
                       spatial_weight=spatial_weight,
                       spectral_weight=spectral_weight)

    def m_step(affiliation, quadratic_form):
        masked_affiliation = affiliation * saliency[..., None, :]
        weight = _integration_weight(masked_affiliation,
                                     weight_constant_axis)
        gaussian = GaussianTrainer()._fit(
            y=embedding.reshape(*batch, 1, F * T, E),
            saliency=masked_affiliation.movedim(-2, -3).reshape(
                *batch, K, F * T),
            covariance_type=covariance_type, reduce=frequency_sum)
        if fixed_covariance is not None:
            assert fixed_covariance.shape == gaussian.covariance.shape, (
                f'{tuple(fixed_covariance.shape)} != '
                f'{tuple(gaussian.covariance.shape)}')
            gaussian = gaussian.__class__(
                mean=gaussian.mean,
                covariance=fixed_covariance.to(gaussian.mean.dtype))
        cacg = ComplexAngularCentralGaussianTrainer()._fit(
            y=observation[..., None, :, :].transpose(-1, -2),
            saliency=masked_affiliation, quadratic_form=quadratic_form,
            hermitize=hermitize, covariance_norm=covariance_norm,
            eigenvalue_floor=eigenvalue_floor)
        return model_of(weight, gaussian, cacg)

    model = m_step(affiliation, torch.ones_like(affiliation))
    if iterations < 2:
        return model
    spherical = covariance_type == 'spherical'
    if use_fused_em == 'loop':
        # the whole fit in ONE launch (K12): only the first M-step above
        # and the Gaussian finish of the last accumulators run here
        fold = Fold(observation, embedding, None)
        cacg, weight = _pin_f32(model.cacg, model.weight)
        g = model.gaussian.__class__(
            mean=model.gaussian.mean.to(torch.float32),
            covariance=model.gaussian.covariance.to(torch.float32))
        spec0 = [fold.utterances(x) for x in _gaussian_state(g, spherical, E)]
        eigenvalues, vectors, weight, acc = \
            integration_em_loop.integration_em_full(
                fold.y, fold.emb, fold.to_bins(cacg.covariance_eigenvectors),
                fold.to_bins(cacg.covariance_eigenvalues),
                fold.to_bins(weight), *spec0, iterations=iterations - 1,
                bins_per_utt=F, spectral_mode='gaussian',
                spherical=spherical, spatial_weight=spatial_weight,
                spectral_weight=spectral_weight,
                affiliation_eps=affiliation_eps,
                eigenvalue_floor=eigenvalue_floor)
        mean, covariance = _gaussian_finish(
            acc[:, :K * E].reshape(-1, K, E), acc[:, K * E:K * E + K],
            acc[:, K * E + K:].reshape(-1, K, E), spherical)
        return model_of(
            fold.from_bins(weight),
            g.__class__(mean=fold.batched(mean),
                        covariance=fold.batched(covariance)),
            ComplexAngularCentralGaussian(
                covariance_eigenvalues=fold.from_bins(eigenvalues),
                covariance_eigenvectors=fold.from_bins(vectors)))
    if use_fused_em == 'step':
        # one K10 pass per iteration; the small M-step finish (the
        # Gaussian moments, from_covariance with K1) in PyTorch
        fold = Fold(observation, embedding,
                    saliency if has_saliency else None)
        tiny = _tiny(torch.float32)
        cacg, weight = _pin_f32(model.cacg, model.weight)
        g = model.gaussian.__class__(
            mean=model.gaussian.mean.to(torch.float32),
            covariance=model.gaussian.covariance.to(torch.float32))
        for _ in range(iterations - 1):
            spec = [fold.utterances(x)
                    for x in _gaussian_state(g, spherical, E)]
            scatter, asum, r, m2 = integration_em.e_stats(
                fold.y, fold.emb,
                eigenvalues=fold.to_bins(cacg.covariance_eigenvalues),
                eigenvectors=fold.to_bins(cacg.covariance_eigenvectors),
                weight=fold.to_bins(weight), mu=spec[0], kappa=spec[1],
                log_c=spec[2], bins_per_utt=F, spectral_mode='gaussian',
                spatial_weight=spatial_weight,
                spectral_weight=spectral_weight,
                affiliation_eps=affiliation_eps, saliency=fold.saliency)
            scatter = fold.from_bins(scatter)  # (*batch, F, K, D, D)
            asum = fold.from_bins(asum)  # (*batch, F, K)
            # the global moments: over every bin of a sharded fit
            r = frequency_sum(fold.from_bins(r).sum(-3))  # (*batch, K, E)
            m2 = frequency_sum(fold.from_bins(m2).sum(-3))
            weight = asum / torch.clamp(asum.sum(-1, keepdim=True), min=tiny)
            mean, covariance = _gaussian_finish(
                r, frequency_sum(asum.sum(-2)), m2, spherical)
            if fixed_covariance is not None:
                covariance = fixed_covariance.to(torch.float32)
            g = g.__class__(mean=mean, covariance=covariance)
            cacg = ComplexAngularCentralGaussian.from_covariance(
                D * scatter / torch.clamp(asum, min=tiny)[
                    ..., None, None].to(scatter.dtype),
                eigenvalue_floor=eigenvalue_floor,
                covariance_norm=covariance_norm)
        return model_of(weight, g, cacg)
    for _ in range(iterations - 1):
        affiliation, quadratic_form = model._predict(
            observation, embedding, affiliation_eps=affiliation_eps,
            inline_permutation_alignment=inline_permutation_alignment)
        model = m_step(affiliation, quadratic_form)
    return model
