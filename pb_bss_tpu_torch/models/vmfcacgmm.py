"""vMF x complex-Angular-Central-Gaussian integration model.

Counterpart of ``pb_bss_tpu.models.vmfcacgmm``: the structure of
:mod:`pb_bss_tpu_torch.models.gcacgmm` with a von Mises-Fisher spectral
model on the unit-normalized embedding, and the router of both
integration trainers, decision for decision
(``pb_bss_tpu/models/vmfcacgmm.py:99-174``):

- ``'auto'`` takes ``'step'`` (K10 per iteration,
  :func:`pb_bss_tpu_torch.ops.integration_em.e_stats`) when
  :func:`_fused_integration_eligible` holds and the scan otherwise; it
  never takes ``'loop'`` (the JAX package measured its whole-fit kernel
  slower than the per-iteration path on the TPU and kept it opt-in).
- ``True`` / ``'step'`` force K10, ``'loop'`` forces K12
  (:func:`pb_bss_tpu_torch.ops.integration_em_loop.integration_em_full`),
  ``False`` keeps the scan. A forced kernel route asserts on knobs the
  kernels do not take (other weight axes, an inline aligner, saliency
  in ``'loop'``).
"""
from __future__ import annotations

import functools
import math
from operator import xor

import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from .._shard import (
    dtensor_entry,
    dtensor_predict,
    frequency_sum,
    squeezed_weight_axis,
)
from ..ops import integration_em, integration_em_loop
from .base import Model, modelclass
from .complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
)
from .gcacgmm import (
    Fold,
    _check_inputs,
    _check_kernel_knobs,
    _initialization,
    _integration_weight,
    _pin_f32,
    fit_integration_em,
    integration_predict,
    normalize_rows,
)
from .von_mises_fisher import VonMisesFisher, VonMisesFisherTrainer

__all__ = ['VMFCACGMM', 'VMFCACGMMTrainer']


@modelclass
class VMFCACGMM(Model):
    weight: torch.Tensor = None
    vmf: VonMisesFisher = None
    cacg: ComplexAngularCentralGaussian = None
    weight_constant_axis: tuple = (-1,)
    spatial_weight: float = 1.
    spectral_weight: float = 1.

    @dtensor_predict({'embedding': -3})
    def predict(self, observation, embedding):
        """observation: (..., F, T, D) complex; embedding: (..., F, T, E)
        real. Returns the affiliation (..., F, K, T). A DTensor
        observation is predicted on each rank's block (the embedding a
        DTensor too, or the global tensor) and the affiliation comes back
        as a DTensor placed as it (``_shard.dtensor_predict``)."""
        assert observation.is_complex(), observation.dtype
        assert not embedding.is_complex(), embedding.dtype
        return self._predict(normalize_rows(observation),
                             normalize_rows(embedding))[0]

    def _predict(self, observation, embedding, affiliation_eps=0.,
                 inline_permutation_alignment=False):
        return integration_predict(
            self, self.vmf, observation, embedding,
            affiliation_eps=affiliation_eps,
            inline_permutation_alignment=inline_permutation_alignment)


def _on_accelerator(x):
    """Do the integration kernels run for ``x``? (CUDA tensors; the JAX
    package asks ``jax.default_backend() != 'cpu'``.)"""
    return x.device.type == 'cuda'


def _fused_integration_eligible(
        observation, embedding, num_classes, saliency, weight_constant_axis,
        inline_permutation_alignment):
    """Route the EM to the per-iteration statistics kernel K10? The
    accelerator, complex64 (F, T, D) or (B, F, T, D) observations, D <= 16,
    no inline aligner, per-bin weights and the kernel's shared-memory
    budget (:func:`pb_bss_tpu_torch.ops.integration_em.fits`). Saliency
    rides the kernel. The JAX package's VMEM budget (``choose_tile_f``)
    limits T; K10 walks T in tiles (a CTA per (bin, time chunk)), so here
    T has no limit."""
    D = observation.shape[-1]
    return (_on_accelerator(observation)
            and observation.ndim in (3, 4)
            and observation.dtype == torch.complex64
            and D <= 16
            and not inline_permutation_alignment
            and weight_constant_axis in ((-1,), -1)
            and integration_em.fits(D, num_classes, embedding.shape[-1]))


def _whole_fit_integration_eligible(
        observation, embedding, num_classes, saliency, weight_constant_axis,
        inline_permutation_alignment, iterations, covariance_norm, hermitize,
        spectral_mode):
    """Could the EM take the whole-fit kernel K12? K10's gate plus: no
    saliency, iterations >= 2, the 'eigenvalue' covariance norm with
    hermitization (what the in-kernel M-step implements), at most 128
    utterances folded into the bins, and the kernel's shared-memory
    budget (:func:`pb_bss_tpu_torch.ops.integration_em_loop.fits`; T has
    no limit, the JAX package's ``choose_tile_f_loop`` VMEM budget had
    one). The grid is sized at launch to the CTAs the card keeps
    co-resident, so any bin count fits it."""
    if not _fused_integration_eligible(
            observation, embedding, num_classes, saliency,
            weight_constant_axis, inline_permutation_alignment):
        return False
    if saliency is not None:
        return False
    if iterations < 2 or covariance_norm != 'eigenvalue' or not hermitize:
        return False
    if math.prod(observation.shape[:-3]) > 128:
        return False
    return integration_em_loop.fits(observation.shape[-1], num_classes,
                                    embedding.shape[-1], spectral_mode)


def _resolve_fused_mode(use_fused_em, step_eligible, loop_eligible):
    """'auto' picks the per-iteration kernel ('step') when it is eligible;
    the whole-fit kernel ('loop') is an explicit opt-in, never 'auto'
    (the JAX package's decision, kept as it stands). True / 'step' force
    K10, 'loop' K12, False the scan."""
    del loop_eligible  # 'auto' never picks 'loop'
    if use_fused_em == 'auto':
        return 'step' if step_eligible else 'off'
    if use_fused_em == 'loop':
        return 'loop'
    if use_fused_em is True or use_fused_em == 'step':
        return 'step'
    assert use_fused_em is False, use_fused_em
    return 'off'


class VMFCACGMMTrainer:
    @dtensor_entry(squeezed_weight_axis, {'embedding': -3, 'saliency': -2})
    def fit(self, observation, embedding, initialization=None,
            num_classes=None, iterations=100, saliency=None, *,
            generator=None, min_concentration=1e-10, max_concentration=500,
            hermitize=True, covariance_norm='eigenvalue',
            eigenvalue_floor=1e-10, affiliation_eps=1e-10,
            weight_constant_axis=(-1,), spatial_weight=1., spectral_weight=1.,
            inline_permutation_alignment=False,
            use_fused_em='auto') -> VMFCACGMM:
        """EM on (..., F, T, D) observations + (..., F, T, E) embeddings.
        Leading batch axes (e.g. (B, F, T, D)) fit independent models per
        utterance. An observation that is a DTensor with its frequency
        axis (-3) split over a mesh's ``'f'`` axis and / or an utterance
        axis left of it over ``'b'`` (from ``parallel.shard_frequencies``,
        ``shard_batch_and_frequencies`` or
        ``shard_batch_from_process_local``) fits each rank's block (the
        embedding a DTensor too, or a tensor with the global value) and
        returns the global model on every rank
        (``_shard.dtensor_entry``); ``'loop'`` then fits every bin of
        the rank's utterances on every rank of ``'f'``
        (``gcacgmm.fit_integration_em``).

        Args:
            generator: ``torch.Generator`` of the random initialization
                (default: one seeded 0 on the observation's device).
            use_fused_em: 'auto' (K10 on the card for eligible input), True
                / 'step' (K10, its plain twin on the CPU), 'loop' (K12),
                False (the scan).
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

        K = initialization.shape[-2]
        mode = _resolve_fused_mode(
            use_fused_em,
            _fused_integration_eligible(
                observation, embedding, K, saliency, weight_constant_axis,
                inline_permutation_alignment),
            _whole_fit_integration_eligible(
                observation, embedding, K, saliency, weight_constant_axis,
                inline_permutation_alignment, int(iterations),
                covariance_norm, bool(hermitize), 'vmf'))
        if mode != 'off':
            _check_kernel_knobs(use_fused_em, weight_constant_axis,
                                inline_permutation_alignment,
                                observation.ndim)
        if mode == 'loop':
            # the whole-fit kernel has no saliency path: running it would
            # silently drop the weighting
            assert saliency is None, (
                "use_fused_em='loop' does not support saliency; use 'step' "
                'or the scan path')
        has_saliency = saliency is not None
        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        else:
            saliency = torch.as_tensor(saliency, device=observation.device)

        fit_em = functools.partial(
            _vmfcacgmm_fit_em, iterations=int(iterations),
            min_concentration=float(min_concentration),
            max_concentration=float(max_concentration),
            hermitize=bool(hermitize), covariance_norm=covariance_norm,
            eigenvalue_floor=float(eigenvalue_floor),
            affiliation_eps=float(affiliation_eps),
            weight_constant_axis=weight_constant_axis,
            spatial_weight=float(spatial_weight),
            spectral_weight=float(spectral_weight),
            inline_permutation_alignment=bool(inline_permutation_alignment),
            use_fused_em=mode, has_saliency=has_saliency)
        return fit_integration_em(fit_em, mode, observation, embedding,
                                  initialization, saliency,
                                  weight_constant_axis)

    def fit_predict(self, observation, embedding, initialization=None,
                    num_classes=None, iterations=100, saliency=None,
                    **kwargs):
        """Fit a model, then return the posterior affiliations."""
        model = self.fit(observation, embedding, initialization,
                         num_classes, iterations, saliency, **kwargs)
        return model.predict(observation, embedding)


def _vmf_finish(r, n, E, min_concentration, max_concentration):
    """[Banerjee2005] closed form on summed resultants r (..., K, E) and
    affiliation sums n (..., K): (mean, concentration)."""
    tiny = _tiny(r)
    norm = torch.linalg.vector_norm(r, dim=-1)
    mean = r / torch.clamp(norm, min=tiny)[..., None]
    r_bar = norm / torch.clamp(n, min=tiny)
    concentration = torch.clamp((r_bar * E - r_bar ** 3) / (1 - r_bar ** 2),
                                min_concentration, max_concentration)
    return mean, concentration


def _vmfcacgmm_fit_em(observation, embedding, affiliation, saliency, *,
                      iterations, min_concentration, max_concentration,
                      hermitize, covariance_norm, eigenvalue_floor,
                      affiliation_eps, weight_constant_axis, spatial_weight,
                      spectral_weight, inline_permutation_alignment,
                      use_fused_em='off', has_saliency=False):
    *batch, F, T, D = observation.shape
    E = embedding.shape[-1]
    K = affiliation.shape[-2]

    def model_of(weight, vmf, cacg):
        return VMFCACGMM(weight=weight, vmf=vmf, cacg=cacg,
                         weight_constant_axis=weight_constant_axis,
                         spatial_weight=spatial_weight,
                         spectral_weight=spectral_weight)

    def m_step(affiliation, quadratic_form):
        masked_affiliation = affiliation * saliency[..., None, :]
        weight = _integration_weight(masked_affiliation,
                                     weight_constant_axis)
        # like the reference, the vMF M-step runs on the *raw* embedding
        # (the resultant length reflects the embedding magnitudes)
        vmf = VonMisesFisherTrainer()._fit(
            y=embedding.reshape(*batch, 1, F * T, E),
            saliency=masked_affiliation.movedim(-2, -3).reshape(
                *batch, K, F * T),
            min_concentration=min_concentration,
            max_concentration=max_concentration, reduce=frequency_sum)
        cacg = ComplexAngularCentralGaussianTrainer()._fit(
            y=observation[..., None, :, :].transpose(-1, -2),
            saliency=masked_affiliation, quadratic_form=quadratic_form,
            hermitize=hermitize, covariance_norm=covariance_norm,
            eigenvalue_floor=eigenvalue_floor)
        return model_of(weight, vmf, cacg)

    model = m_step(affiliation, torch.ones_like(affiliation))
    if iterations < 2:
        return model
    if use_fused_em == 'loop':
        # the whole fit in ONE launch (K12): only the first M-step above
        # and the vMF finish of the last accumulators run here
        fold = Fold(observation, embedding, None)
        cacg, weight = _pin_f32(model.cacg, model.weight)
        vmf = VonMisesFisher(
            mean=model.vmf.mean.to(torch.float32),
            concentration=model.vmf.concentration.to(torch.float32))
        spec0 = [fold.utterances(x)
                 for x in (vmf.mean, vmf.concentration, vmf.log_norm())]
        eigenvalues, vectors, weight, acc = \
            integration_em_loop.integration_em_full(
                fold.y, fold.emb, fold.to_bins(cacg.covariance_eigenvectors),
                fold.to_bins(cacg.covariance_eigenvalues),
                fold.to_bins(weight), *spec0, iterations=iterations - 1,
                bins_per_utt=F, spectral_mode='vmf',
                spatial_weight=spatial_weight,
                spectral_weight=spectral_weight,
                affiliation_eps=affiliation_eps,
                eigenvalue_floor=eigenvalue_floor,
                min_concentration=min_concentration,
                max_concentration=max_concentration)
        mean, concentration = _vmf_finish(
            acc[:, :K * E].reshape(-1, K, E), acc[:, K * E:K * E + K], E,
            min_concentration, max_concentration)
        return model_of(
            fold.from_bins(weight),
            VonMisesFisher(mean=fold.batched(mean),
                           concentration=fold.batched(concentration)),
            ComplexAngularCentralGaussian(
                covariance_eigenvalues=fold.from_bins(eigenvalues),
                covariance_eigenvectors=fold.from_bins(vectors)))
    if use_fused_em == 'step':
        # one K10 pass per iteration; the small M-step finish (the
        # Banerjee closed form, from_covariance with K1) in PyTorch
        fold = Fold(observation, embedding,
                    saliency if has_saliency else None)
        tiny = _tiny(torch.float32)
        cacg, weight = _pin_f32(model.cacg, model.weight)
        vmf = VonMisesFisher(
            mean=model.vmf.mean.to(torch.float32),
            concentration=model.vmf.concentration.to(torch.float32))
        for _ in range(iterations - 1):
            scatter, asum, r, _ = integration_em.e_stats(
                fold.y, fold.emb,
                eigenvalues=fold.to_bins(cacg.covariance_eigenvalues),
                eigenvectors=fold.to_bins(cacg.covariance_eigenvectors),
                weight=fold.to_bins(weight),
                mu=fold.utterances(vmf.mean),
                kappa=fold.utterances(vmf.concentration),
                log_c=fold.utterances(vmf.log_norm()), bins_per_utt=F,
                spectral_mode='vmf', spatial_weight=spatial_weight,
                spectral_weight=spectral_weight,
                affiliation_eps=affiliation_eps, saliency=fold.saliency)
            scatter = fold.from_bins(scatter)  # (*batch, F, K, D, D)
            asum = fold.from_bins(asum)  # (*batch, F, K)
            # the global resultants: over every bin of a sharded fit
            r = frequency_sum(fold.from_bins(r).sum(-3))  # (*batch, K, E)
            weight = asum / torch.clamp(asum.sum(-1, keepdim=True), min=tiny)
            mean, concentration = _vmf_finish(
                r, frequency_sum(asum.sum(-2)), E, min_concentration,
                max_concentration)
            vmf = VonMisesFisher(mean=mean, concentration=concentration)
            cacg = ComplexAngularCentralGaussian.from_covariance(
                D * scatter / torch.clamp(asum, min=tiny)[
                    ..., None, None].to(scatter.dtype),
                eigenvalue_floor=eigenvalue_floor,
                covariance_norm=covariance_norm)
        return model_of(weight, vmf, cacg)
    for _ in range(iterations - 1):
        affiliation, quadratic_form = model._predict(
            observation, embedding, affiliation_eps=affiliation_eps,
            inline_permutation_alignment=inline_permutation_alignment)
        model = m_step(affiliation, quadratic_form)
    return model
