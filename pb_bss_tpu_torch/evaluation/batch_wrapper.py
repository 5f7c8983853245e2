"""Batched output and input metrics on the device.

Counterpart of ``pb_bss_tpu.evaluation.batch_wrapper``: the facades of
:mod:`.wrapper` for *batches* of utterances, with one leading batch
shape on every input and output. BSS-Eval and the STOI of its
selection run as one fused device pass over the whole batch
(:mod:`._fused_eval_device`, one device-to-host copy), SI-SDR is a
closed form on the device, SRMR runs as the device program on a CUDA
``device`` and as the host oracle on the CPU (the JAX package's rule,
with its default backend replaced by the device the caller names), and
the invasive SXR metrics and PESQ stay on the host.

``device`` ('cuda' by default) is where the device programs run; a CUDA
device without CUDA raises. Inputs may be arrays or tensors, those on
the card (``separate_batch``'s output) included.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ._fused_eval_device import bss_eval_stoi_fused_batch
from .module_bss_eval_device import bss_eval_sources_batch
from .module_pesq import pesq
from .module_si_sdr import si_sdr, si_sdr_allow_float32
from .module_srmr import srmr
from .module_srmr_device import srmr_batch
from .module_stoi_device import stoi_batch
from .sxr_module import input_sxr, output_sxr
from .wrapper import _SI_SDR_DISABLED_HINT, _MetricsFacade, _numpy, \
    _pesq_available, _tensor

__all__ = ['InputMetricsBatch', 'OutputMetricsBatch']


class _BatchFacade(_MetricsFacade):

    def _srmr(self, signals, leading):
        """SRMR of (..., N) signals: the device program on a CUDA
        device, the host oracle per signal on the CPU."""
        if self.device.type != 'cpu':
            return srmr_batch(signals, self.sample_rate, device=self.device)
        flat = _numpy(signals).reshape((-1, self.samples))
        return np.array([srmr(row, self.sample_rate)
                         for row in flat]).reshape(leading)

    def _pesq(self, reference, estimation, leading):
        flat_ref = _numpy(reference).reshape((-1, self.samples))
        flat_est = _numpy(estimation).reshape((-1, self.samples))
        return np.array([pesq(r, e, self.sample_rate)
                         for r, e in zip(flat_ref, flat_est)]).reshape(
            leading)


class InputMetricsBatch(_BatchFacade):
    """Batched counterpart of ``InputMetrics``: metrics of the
    unprocessed observations vs the clean sources for a whole batch of
    utterances, BSS-Eval + STOI as one fused device pass (channels x
    utterances are its batch axis).

    Args:
        observation: (..., D, N) mixtures.
        speech_source: (..., K_source, N) clean sources.
        speech_image / noise_image: optional (..., K_source, D, N) /
            (..., D, N) sensor images enabling the invasive metrics.
        sample_rate: needed by STOI / SRMR.
        enable_si_sdr: see ``InputMetrics``.
        device: where the device programs run ('cuda' by default).
    """

    def __init__(self, observation, speech_source, speech_image=None,
                 noise_image=None, sample_rate: int = None,
                 enable_si_sdr: bool = False, device='cuda'):
        where = self._place(device, True)
        self.observation = _tensor(observation, where)
        self.speech_source = _tensor(speech_source, where)
        self.speech_image = _tensor(speech_image, where)
        self.noise_image = _tensor(noise_image, where)
        self.sample_rate = sample_rate
        self.enable_si_sdr = enable_si_sdr
        self._has_image_signals = (
            speech_image is not None and noise_image is not None)

        assert self.observation.ndim >= 3, (
            'Expected batched (..., D, N) observations; use '
            'InputMetrics for a single utterance.',
            self.observation.shape)
        self.batch_shape = tuple(self.observation.shape[:-2])
        self.channels, self.samples = self.observation.shape[-2:]
        self.K_source = self.speech_source.shape[-2]
        assert self.speech_source.shape == (
            self.batch_shape + (self.K_source, self.samples)), (
            self.speech_source.shape, self.observation.shape)
        if self._has_image_signals:
            assert self.speech_image.shape == (
                self.batch_shape
                + (self.K_source, self.channels, self.samples)), (
                self.speech_image.shape)
            assert self.noise_image.shape == self.observation.shape, (
                self.noise_image.shape, self.observation.shape)

    @cached_property
    def _broadcast_pair(self):
        """(..., K, D, N) views pairing every speaker with every
        channel (the ``InputMetrics`` convention)."""
        shape = (self.batch_shape
                 + (self.K_source, self.channels, self.samples))
        return (self.speech_source[..., :, None, :].expand(shape),
                self.observation[..., None, :, :].expand(shape))

    @cached_property
    def _fused_eval(self):
        """BSS-Eval + STOI for the whole batch in one device pass
        (requires a sample rate for the STOI resampler)."""
        reference, estimation = self._broadcast_pair
        out = bss_eval_stoi_fused_batch(
            reference=reference.transpose(-3, -2),   # (..., D, K, N)
            estimation=estimation.transpose(-3, -2),
            sample_rate=self.sample_rate, compute_permutation=False,
            device=self.device)
        return {key: np.swapaxes(out[key], -2, -1)  # -> (..., K, D)
                for key in ('sdr', 'sir', 'sar', 'stoi')}

    @cached_property
    def mir_eval(self):
        if self.sample_rate is not None:
            out = dict(self._fused_eval)
            out.pop('stoi')
            return out
        # no sample rate -> BSS-Eval alone (STOI needs the resampler)
        reference, estimation = self._broadcast_pair
        out = bss_eval_sources_batch(
            reference=reference.transpose(-3, -2),
            estimation=estimation.transpose(-3, -2),
            compute_permutation=False, device=self.device)
        return {key: np.swapaxes(out[key], -2, -1)
                for key in ('sdr', 'sir', 'sar')}

    @cached_property
    def mir_eval_sdr(self):
        return self.mir_eval['sdr']

    @cached_property
    def mir_eval_sir(self):
        return self.mir_eval['sir']

    @cached_property
    def mir_eval_sar(self):
        return self.mir_eval['sar']

    @cached_property
    def stoi(self):
        assert self.sample_rate is not None, (
            'STOI needs a sample rate; construct InputMetricsBatch '
            'with sample_rate=...')
        return self._fused_eval['stoi']

    @cached_property
    def srmr(self):
        return self._srmr(self.observation,
                          self.batch_shape + (self.channels,))

    @cached_property
    def pesq(self):
        return self._pesq(*self._broadcast_pair,
                          self.batch_shape + (self.K_source, self.channels))

    @cached_property
    def si_sdr(self):
        if not self.enable_si_sdr:
            raise ValueError(_SI_SDR_DISABLED_HINT)
        return _numpy(si_sdr(
            reference=self.speech_source[..., :, None, :],
            estimation=self.observation[..., None, :, :],
            allow_float32=si_sdr_allow_float32(
                self.speech_source, self.observation)))

    @cached_property
    def invasive_sxr(self):
        images = _numpy(self.speech_image).reshape(
            (-1, self.K_source, self.channels, self.samples))
        noises = _numpy(self.noise_image).reshape(
            (-1, self.channels, self.samples))
        rows = [
            input_sxr(images[b], noises[b], average_sources=False,
                      average_channels=False, return_dict=True)
            for b in range(images.shape[0])
        ]
        return {
            key: np.stack([row[key] for row in rows]).reshape(
                self.batch_shape + (self.K_source, self.channels))
            for key in ('sdr', 'sir', 'snr')
        }

    @cached_property
    def invasive_sdr(self):
        return self.invasive_sxr['sdr']

    @cached_property
    def invasive_sir(self):
        return self.invasive_sxr['sir']

    @cached_property
    def invasive_snr(self):
        return self.invasive_sxr['snr']

    def _metric_groups(self):
        return [
            (_pesq_available(), ('pesq',)),
            (True, ('stoi', 'mir_eval_sdr', 'mir_eval_sir',
                    'mir_eval_sar', 'srmr')),
            (self.enable_si_sdr, ('si_sdr',)),
            (self._has_image_signals,
             ('invasive_sdr', 'invasive_snr', 'invasive_sir')),
        ]


class OutputMetricsBatch(_BatchFacade):
    """Lazily evaluated metrics of a batch of separated utterances.

    Same metric names and alignment semantics as ``OutputMetrics``,
    with one leading batch shape on every input and output.

    Args:
        speech_prediction: (..., K_target, N) separated estimates;
            K_target may be K_source + 1 (extra noise estimate).
        speech_source: (..., K_source, N) true sources.
        speech_contribution: (..., K_source, K_target, N) per-source
            outputs of the linear system with fixed parameters;
            together with ``noise_contribution`` enables the invasive
            SXR metrics.
        noise_contribution: (..., K_target, N).
        sample_rate: sampling rate (STOI / PESQ / SRMR need it).
        enable_si_sdr: SI-SDR is only well defined for non-reverb
            single-channel references, so it is disabled by default.
        compute_permutation: use the BSS-Eval SIR permutation to align
            all other metrics (required when K_target == K_source + 1).
        device: where the device programs run ('cuda' by default).
    """

    def __init__(
            self,
            speech_prediction,
            speech_source,
            speech_contribution=None,
            noise_contribution=None,
            sample_rate: int = None,
            enable_si_sdr: bool = False,
            compute_permutation: bool = True,
            device='cuda',
    ):
        where = self._place(device, True)
        self.speech_prediction = _tensor(speech_prediction, where)
        self.speech_source = _tensor(speech_source, where)
        self.speech_contribution = _tensor(speech_contribution, where)
        self.noise_contribution = _tensor(noise_contribution, where)
        self.sample_rate = sample_rate
        self.enable_si_sdr = enable_si_sdr
        self.compute_permutation = compute_permutation

        self._has_contribution_signals = (
            speech_contribution is not None
            and noise_contribution is not None)

        assert self.speech_prediction.ndim >= 3, (
            'Expected batched (..., K_target, N) predictions; use '
            'OutputMetrics for a single utterance.',
            self.speech_prediction.shape)
        self.batch_shape = tuple(self.speech_prediction.shape[:-2])
        self.samples = self.speech_prediction.shape[-1]
        self.K_source = self.speech_source.shape[-2]
        self.K_target = self.speech_prediction.shape[-2]
        self.check_inputs()

    def check_inputs(self):
        assert tuple(self.speech_source.shape[:-2]) == self.batch_shape, (
            self.speech_source.shape, self.speech_prediction.shape)
        assert self.speech_source.shape[-1] == self.samples, (
            self.speech_source.shape, self.speech_prediction.shape)
        assert self.K_source <= 8, self.speech_source.shape
        assert self.K_target in (self.K_source, self.K_source + 1), (
            self.K_target, self.K_source)
        if self.K_target == self.K_source + 1:
            assert self.compute_permutation, (
                'The extra (noise) estimate requires the permutation '
                'search to route it.')
        if self._has_contribution_signals:
            assert self.speech_contribution.shape == (
                self.batch_shape
                + (self.K_source, self.K_target, self.samples)), (
                self.speech_contribution.shape)
            assert self.noise_contribution.shape == (
                self.batch_shape + (self.K_target, self.samples)), (
                self.noise_contribution.shape)
            deviation = float((
                self.speech_prediction
                - self.speech_contribution.sum(-3)
                - self.noise_contribution).abs().std(correction=0))
            assert deviation < 1e-3, (
                'speech_prediction should equal the sum of the '
                f'contribution signals; deviation: {deviation}')
        else:
            assert (self.speech_contribution is None
                    and self.noise_contribution is None), (
                'Pass speech_contribution and noise_contribution '
                'together or not at all.')

    @cached_property
    def _fused_eval(self):
        """BSS-Eval + selection-aligned STOI for the whole batch in one
        device pass and one copy to the host (requires a sample rate
        for the STOI resampler)."""
        return bss_eval_stoi_fused_batch(
            reference=self.speech_source,
            estimation=self.speech_prediction,
            sample_rate=self.sample_rate,
            compute_permutation=self.compute_permutation,
            device=self.device)

    @cached_property
    def mir_eval(self):
        if self.sample_rate is not None:
            out = dict(self._fused_eval)
            out.pop('stoi')
            return out
        return bss_eval_sources_batch(
            reference=self.speech_source,
            estimation=self.speech_prediction,
            compute_permutation=self.compute_permutation,
            device=self.device)

    @cached_property
    def mir_eval_sdr(self):
        return self.mir_eval['sdr']

    @cached_property
    def mir_eval_sir(self):
        return self.mir_eval['sir']

    @cached_property
    def mir_eval_sar(self):
        return self.mir_eval['sar']

    @cached_property
    def mir_eval_selection(self):
        if self.compute_permutation:
            return self.mir_eval['selection']
        return np.broadcast_to(
            np.arange(self.K_source),
            self.batch_shape + (self.K_source,)).copy()

    @cached_property
    def speech_prediction_selection(self):
        selection = torch.as_tensor(self.mir_eval_selection,
                                    device=self.speech_prediction.device)
        return self.speech_prediction.gather(-2, selection[..., None].expand(
            selection.shape + (self.samples,)))

    @cached_property
    def stoi(self):
        if self.sample_rate is not None:
            return self._fused_eval['stoi']
        return stoi_batch(
            reference=self.speech_source,
            estimation=self.speech_prediction_selection,
            sample_rate=self.sample_rate, device=self.device)

    @cached_property
    def si_sdr(self):
        if not self.enable_si_sdr:
            raise ValueError(_SI_SDR_DISABLED_HINT)
        return _numpy(si_sdr(
            reference=self.speech_source,
            estimation=self.speech_prediction_selection,
            allow_float32=si_sdr_allow_float32(
                self.speech_source, self.speech_prediction_selection)))

    @cached_property
    def invasive_sxr(self):
        sel = self.mir_eval_selection.reshape(-1, self.K_source)
        speech = _numpy(self.speech_contribution).reshape(
            (-1, self.K_source, self.K_target, self.samples))
        noise = _numpy(self.noise_contribution).reshape(
            (-1, self.K_target, self.samples))
        rows = [
            output_sxr(speech[b][:, sel[b], :], noise[b][sel[b], :],
                       average_sources=False, return_dict=True)
            for b in range(speech.shape[0])
        ]
        return {
            key: np.stack([row[key] for row in rows]).reshape(
                self.batch_shape + (self.K_source,))
            for key in ('sdr', 'sir', 'snr')
        }

    @cached_property
    def invasive_sdr(self):
        return self.invasive_sxr['sdr']

    @cached_property
    def invasive_sir(self):
        return self.invasive_sxr['sir']

    @cached_property
    def invasive_snr(self):
        return self.invasive_sxr['snr']

    @cached_property
    def pesq(self):
        reference = self.speech_source.expand(
            self.speech_prediction_selection.shape)
        return self._pesq(reference, self.speech_prediction_selection,
                          self.batch_shape + (self.K_source,))

    @cached_property
    def srmr(self):
        return self._srmr(self.speech_prediction_selection,
                          self.batch_shape + (self.K_source,))

    def _metric_groups(self):
        return [
            (_pesq_available(), ('pesq',)),
            (True, ('stoi', 'mir_eval_sdr', 'mir_eval_sir',
                    'mir_eval_sar', 'mir_eval_selection', 'srmr')),
            (self.enable_si_sdr, ('si_sdr',)),
            (self._has_contribution_signals,
             ('invasive_sdr', 'invasive_snr', 'invasive_sir')),
        ]
