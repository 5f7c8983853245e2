"""Metric facades: ``InputMetrics`` / ``OutputMetrics``.

Counterpart of ``pb_bss_tpu.evaluation.wrapper``: lazily evaluated
cached metrics, shape contracts with verbose error messages, the
mir_eval permutation ``selection`` reused to align every other metric,
K_target in {K, K+1}, and dict access with difflib suggestions. Both
facades share ``_MetricsFacade``, which turns a list of gated metric
groups into ``as_dict`` / ``__getitem__`` and the available / disabled
names.

Routing. The JAX package routes by its default backend; the port routes
by the device the caller names:

* ``device`` ('cuda' by default) is where the device programs run; a
  CUDA device without CUDA raises, it never drops to the host.
* ``device_metrics=None`` runs BSS-Eval, STOI and SRMR as the device
  programs (:mod:`.module_bss_eval_device`, :mod:`.module_stoi_device`,
  :mod:`.module_srmr_device`; BSS-Eval and STOI fused, one
  device-to-host copy) on a CUDA device, and the host float64 oracles
  on ``device='cpu'``; ``False`` forces the host oracles, ``True`` the
  device programs (on the CPU too).
* Inputs may be NumPy arrays or tensors, those already on the card (the
  output of ``separate_batch``) included. The device programs compute
  in float64 when every input is float64, else in float32.

PESQ needs the optional ``pesq`` C library; without it ``as_dict``
skips 'pesq' and lists it under the disabled metrics. The invasive SXR
metrics and PESQ run on the host.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from .._device import resolve_device
from ._fused_eval_device import (
    bss_eval_stoi_fused,
    bss_eval_stoi_fused_batch,
)
from .module_bss_eval_device import bss_eval_sources_batch
from .module_mir_eval import mir_eval_sources
from .module_pesq import pesq
from .module_si_sdr import si_sdr, si_sdr_allow_float32
from .module_srmr import srmr
from .module_srmr_device import srmr_batch
from .module_stoi import stoi
from .sxr_module import input_sxr, output_sxr

_SYMBOLIC_SHAPES = (
    ('speech_prediction', '(K_target, N)'),
    ('speech_source', '(K_source, N)'),
    ('speech_contribution', '(K_source, K_target, N)'),
    ('noise_contribution', '(K_target, N)'),
)


def _get_err_msg(msg, metrics: 'OutputMetrics'):
    """Append an inventory of every input's actual and symbolic shape
    to ``msg``, so a failed contract shows the whole picture at once."""
    lines = [f'{msg}', 'Shapes: (is shape) (symbolic shape)']
    for attr, symbolic in _SYMBOLIC_SHAPES:
        value = getattr(metrics, attr)
        if value is not None:
            lines.append(f'\t{attr}: {tuple(value.shape)} {symbolic}')
    return '\n'.join(lines)


class VerboseKeyError(KeyError):
    """KeyError that lists similarly-spelled keys (via difflib) and an
    optional trailing note — raised as ``VerboseKeyError(item, keys)``
    or ``VerboseKeyError(item, keys, note)``."""

    def __str__(self):
        if len(self.args) not in (2, 3):
            return super().__str__()
        import difflib
        item, keys, *note = self.args
        suggestions = difflib.get_close_matches(item, keys, cutoff=0, n=100)
        return '\n'.join(
            [f'{item!r}.', f'Close matches: {suggestions!r}'] + note)


def _tensor(x, device):
    """``x`` (array or tensor) as a tensor on ``device``, its dtype kept;
    None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _numpy(x):
    return x.detach().cpu().numpy()


def _pesq_available():
    try:
        import pesq  # noqa: F401
        return True
    except ImportError:
        return False


def _entry(source, key):
    """Property factory: read one entry of the dict-valued cached
    metric ``source`` (the parent is cached, so the view need not be)."""

    def view(self):
        return getattr(self, source)[key]

    view.__doc__ = f'The {key!r} entry of :attr:`{source}`.'
    return property(view)


_SI_SDR_DISABLED_HINT = (
    'SI-SDR needs a non-reverberant single-channel reference to '
    'be meaningful, so it is off unless you opt in with '
    '`enable_si_sdr=True`.'
)


class _MetricsFacade:
    """Shared dict-like access over gated groups of lazy metrics.

    Subclasses implement ``_metric_groups`` returning ``(gate, names)``
    pairs in presentation order; a falsy gate moves the whole group to
    the disabled list.
    """

    def _metric_groups(self):
        raise NotImplementedError

    def _available_metric_names(self):
        return tuple(
            name
            for gate, names in self._metric_groups() if gate
            for name in names
        )

    def _disabled_metric_names(self):
        return [
            name
            for gate, names in self._metric_groups() if not gate
            for name in names
        ]

    def as_dict(self):
        """Evaluate every available metric once; disabled ones are
        silently absent (look at ``_disabled_metric_names``)."""
        return {name: self[name]
                for name in self._available_metric_names()}

    def __getitem__(self, item):
        assert isinstance(item, str), (type(item), item)
        try:
            return getattr(self, item)
        except AttributeError:
            pass
        raise VerboseKeyError(
            item,
            self._available_metric_names(),
            f'Disabled: {self._disabled_metric_names()}',
        )

    def _place(self, device, device_metrics):
        """Resolve the routing; returns the device the inputs live on
        (the host when the host oracles run)."""
        self.device = resolve_device(device)
        self.device_metrics = device_metrics
        self._use_device_metrics = (
            self.device.type != 'cpu' if device_metrics is None
            else bool(device_metrics))
        return self.device if self._use_device_metrics \
            else torch.device('cpu')


class InputMetrics(_MetricsFacade):
    """Metrics of the unprocessed observation vs the clean sources
    (broadcast channels x speakers)."""

    def __init__(self, observation, speech_source, speech_image=None,
                 noise_image=None, sample_rate=None, enable_si_sdr=False,
                 device_metrics=None, device='cuda'):
        """
        Args:
            observation: (D, N) mixture; D channels yield D metric
                values per speaker — slice to a singleton channel dim
                to pick a reference channel.
            speech_source: (K_source, N) clean sources.
            speech_image: (K_source, D, N) reverberant source images
                (enables the invasive SXR metrics, with noise_image).
            noise_image: (D, N) noise at the sensors.
            enable_si_sdr: SI-SDR is only well defined for non-reverb
                single-channel data, so it is disabled by default.
            device_metrics: route BSS-Eval, STOI and SRMR through the
                device programs (``None``: on a CUDA ``device`` — see
                the module docstring).
            device: where the device programs run ('cuda' by default).
        """
        where = self._place(device, device_metrics)
        self.observation = _tensor(observation, where)
        self.speech_source = _tensor(speech_source, where)
        self.speech_image = _tensor(speech_image, where)
        self.noise_image = _tensor(noise_image, where)
        self.sample_rate = sample_rate
        self.enable_si_sdr = enable_si_sdr

        self._has_image_signals = (
            speech_image is not None and noise_image is not None)
        self.channels, self.samples = self.observation.shape[-2:]
        self.K_source = self.speech_source.shape[0]
        self.check_inputs()

    def check_inputs(self):
        for name in ('observation', 'speech_source'):
            arr = getattr(self, name)
            assert arr.ndim == 2, (name, arr.shape)

    def _broadcast_pair(self):
        """(K, D, N) views pairing every speaker with every channel."""
        shape = (self.K_source, self.channels, self.samples)
        return (self.speech_source[:, None, :].expand(shape),
                self.observation[None, :, :].expand(shape))

    @cached_property
    def _device_eval(self):
        """Channel-batched BSS-Eval + STOI in one device pass and one
        copy to the host. The host scores channel d as one K-vs-K call
        without permutation; here the channel axis is the batch axis."""
        reference, estimation = self._broadcast_pair()
        out = bss_eval_stoi_fused_batch(
            reference=reference.transpose(0, 1),
            estimation=estimation.transpose(0, 1),
            sample_rate=self.sample_rate, compute_permutation=False,
            device=self.device)
        return {key: out[key].T for key in ('sdr', 'sir', 'sar', 'stoi')}

    @cached_property
    def mir_eval(self):
        if self._use_device_metrics:
            if self.sample_rate is not None:
                out = dict(self._device_eval)
                out.pop('stoi')
                return out
            reference, estimation = self._broadcast_pair()
            out = bss_eval_sources_batch(
                reference=reference.transpose(0, 1),
                estimation=estimation.transpose(0, 1),
                compute_permutation=False, device=self.device)
            return {key: out[key].T for key in ('sdr', 'sir', 'sar')}
        reference, estimation = map(_numpy, self._broadcast_pair())
        return mir_eval_sources(
            reference=reference, estimation=estimation,
            return_dict=True, compute_permutation=False)

    mir_eval_sdr = _entry('mir_eval', 'sdr')
    mir_eval_sir = _entry('mir_eval', 'sir')
    mir_eval_sar = _entry('mir_eval', 'sar')

    @cached_property
    def pesq(self):
        reference, estimation = map(_numpy, self._broadcast_pair())
        return pesq(reference, estimation, sample_rate=self.sample_rate)

    @cached_property
    def invasive_sxr(self):
        return input_sxr(
            _numpy(self.speech_image), _numpy(self.noise_image),
            average_sources=False, average_channels=False,
            return_dict=True)

    invasive_sdr = _entry('invasive_sxr', 'sdr')
    invasive_sir = _entry('invasive_sxr', 'sir')
    invasive_snr = _entry('invasive_sxr', 'snr')

    @cached_property
    def stoi(self):
        if self._use_device_metrics and self.sample_rate is not None:
            return self._device_eval['stoi']
        reference, estimation = map(_numpy, self._broadcast_pair())
        return stoi(reference=reference, estimation=estimation,
                    sample_rate=self.sample_rate)

    @cached_property
    def si_sdr(self):
        if not self.enable_si_sdr:
            raise ValueError(_SI_SDR_DISABLED_HINT)
        return _numpy(si_sdr(
            reference=self.speech_source[:, None, :],
            estimation=self.observation[None, :, :],
            allow_float32=si_sdr_allow_float32(
                self.speech_source, self.observation)))

    @cached_property
    def srmr(self):
        if self._use_device_metrics:
            return srmr_batch(self.observation, self.sample_rate,
                              device=self.device)
        return srmr(_numpy(self.observation), self.sample_rate)

    def _metric_groups(self):
        return [
            (_pesq_available(), ('pesq',)),
            (True, ('stoi', 'mir_eval_sdr', 'mir_eval_sir',
                    'mir_eval_sar', 'srmr')),
            (self.enable_si_sdr, ('si_sdr',)),
            (self._has_image_signals,
             ('invasive_sdr', 'invasive_snr', 'invasive_sir')),
        ]


class OutputMetrics(_MetricsFacade):
    """Metrics of the separated estimates vs the clean sources."""

    def __init__(self, speech_prediction, speech_source,
                 speech_contribution=None, noise_contribution=None,
                 sample_rate=None, enable_si_sdr=False,
                 compute_permutation=True, device_metrics=None,
                 device='cuda'):
        """
        Args:
            speech_prediction: (K_target, N) separated estimates;
                K_target may be K_source + 1 (extra noise estimate).
            speech_source: (K_source, N) true sources (pre-reverb).
            speech_contribution: (K_source, K_target, N) per-source
                outputs of the (linear) separation system with fixed
                parameters; with noise_contribution, enables the
                invasive SXR metrics.
            noise_contribution: (K_target, N) noise-only output of the
                same fixed system.
            compute_permutation: use the mir_eval SIR permutation to
                align all other metrics.
            device_metrics: route BSS-Eval, STOI and SRMR through the
                device programs. ``None`` (default) on a CUDA
                ``device``, the host float64 oracles on the CPU;
                ``False`` forces the host oracles; ``True`` the device
                programs (a fully silent estimate yields NaN STOI where
                the host raises).
            device: where the device programs run ('cuda' by default).
        """
        where = self._place(device, device_metrics)
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
        self.K_target = self.speech_prediction.shape[0]
        self.samples = self.speech_prediction.shape[-1]
        self.K_source = self.speech_source.shape[0]
        self.check_inputs()

    def check_inputs(self):
        for name in ('speech_prediction', 'speech_source'):
            arr = getattr(self, name)
            assert arr.ndim == 2, (name, arr.shape)

        assert self.K_source <= 8, _get_err_msg(
            f'speech_source claims {self.K_source} speakers (K_source); '
            f'more than 8 is almost certainly a transposed input.',
            self)
        assert self.K_target <= 8, _get_err_msg(
            f'speech_prediction claims {self.K_target} estimates '
            f'(K_target); more than 8 is almost certainly a transposed '
            f'input.',
            self)
        assert self.K_target in [self.K_source, self.K_source + 1], \
            _get_err_msg(
                'K_target must be K_source (one estimate per speaker) or '
                'K_source + 1 (an extra noise estimate).',
                self)
        assert self.speech_source.shape[-1] == self.samples, _get_err_msg(
            'speech_source and speech_prediction disagree on the sample '
            'count (N).', self)

        if self._has_contribution_signals:
            self._check_contributions()
        else:
            assert (self.speech_contribution is None
                    and self.noise_contribution is None), (
                'speech_contribution and noise_contribution only make '
                'sense together: pass both (invasive metrics on) or '
                'neither.\nGot:\n'
                f'speech_contribution: {self.speech_contribution}\n'
                f'noise_contribution: {self.noise_contribution}')

    def _check_contributions(self):
        """Contracts on the invasive-metric inputs: shapes consistent
        with the prediction, and the contributions actually summing to
        it (otherwise the system was not linear / parameters moved)."""
        expected = {
            'speech_contribution':
                (self.K_source, self.K_target, self.samples),
            'noise_contribution': (self.K_target, self.samples),
        }
        axis_names = {
            self.K_source: 'speaker count (K_source)',
            self.K_target: 'estimate count (K_target)',
            self.samples: 'sample count (N)',
        }
        for attr, want in expected.items():
            got = tuple(getattr(self, attr).shape)
            assert got == want, _get_err_msg(
                f'{attr} has shape {got}, expected {want} — check the '
                + ' / '.join(axis_names[n] for n in dict.fromkeys(want))
                + '.', self)
        residual = (
            self.speech_prediction
            - self.speech_contribution.sum(0)
            - self.noise_contribution)
        deviation = float(residual.abs().std(correction=0))
        assert deviation < 1e-3, (
            'Invasive metrics need the contributions to add up to '
            'the prediction (linear system); the deviation (residual '
            f'std) here is {deviation}.')

    @cached_property
    def mir_eval_selection(self):
        if not self.compute_permutation:
            assert self.K_target == self.K_source, (
                self.K_target, self.K_source, self.compute_permutation)
            return np.arange(self.K_source)
        return self.mir_eval['selection']

    @cached_property
    def speech_prediction_selection(self):
        """The estimates reordered into source order (and, for
        K_target == K_source + 1, with the noise estimate dropped)."""
        assert self.speech_prediction.ndim == 2, \
            self.speech_prediction.shape
        assert self.speech_prediction.shape[0] < 10, \
            self.speech_prediction.shape
        n_selected = len(self.mir_eval_selection)
        assert self.speech_prediction.shape[0] in (
            n_selected, n_selected + 1), self.speech_prediction.shape
        return self.speech_prediction[torch.as_tensor(
            self.mir_eval_selection, device=self.speech_prediction.device)]

    @cached_property
    def _device_eval(self):
        """BSS-Eval + selection-aligned STOI in one device pass and one
        copy to the host."""
        return bss_eval_stoi_fused(
            reference=self.speech_source,
            estimation=self.speech_prediction,
            sample_rate=self.sample_rate,
            compute_permutation=self.compute_permutation,
            device=self.device)

    @cached_property
    def mir_eval(self):
        if self._use_device_metrics:
            if self.sample_rate is not None:
                out = dict(self._device_eval)
                out.pop('stoi')
            else:
                out = bss_eval_sources_batch(
                    reference=self.speech_source[None],
                    estimation=self.speech_prediction[None],
                    compute_permutation=self.compute_permutation,
                    device=self.device)
                out = {key: value[0] for key, value in out.items()}
            if not self.compute_permutation:
                out.pop('selection')
            return out
        return mir_eval_sources(
            reference=_numpy(self.speech_source),
            estimation=_numpy(self.speech_prediction), return_dict=True,
            compute_permutation=self.compute_permutation)

    mir_eval_sdr = _entry('mir_eval', 'sdr')
    mir_eval_sir = _entry('mir_eval', 'sir')
    mir_eval_sar = _entry('mir_eval', 'sar')

    @cached_property
    def pesq(self):
        return pesq(
            reference=_numpy(self.speech_source),
            estimation=_numpy(self.speech_prediction_selection),
            sample_rate=self.sample_rate)

    @cached_property
    def invasive_sxr(self):
        selection = self.mir_eval_selection
        return output_sxr(
            _numpy(self.speech_contribution)[:, selection, :],
            _numpy(self.noise_contribution)[selection, :],
            average_sources=False, return_dict=True)

    invasive_sdr = _entry('invasive_sxr', 'sdr')
    invasive_sir = _entry('invasive_sxr', 'sir')
    invasive_snr = _entry('invasive_sxr', 'snr')

    @cached_property
    def stoi(self):
        if self._use_device_metrics:
            return self._device_eval['stoi']
        return stoi(
            reference=_numpy(self.speech_source),
            estimation=_numpy(self.speech_prediction_selection),
            sample_rate=self.sample_rate)

    @cached_property
    def srmr(self):
        if self._use_device_metrics:
            return srmr_batch(self.speech_prediction_selection,
                              self.sample_rate, device=self.device)
        return srmr(_numpy(self.speech_prediction_selection),
                    self.sample_rate)

    @cached_property
    def si_sdr(self):
        if not self.enable_si_sdr:
            raise ValueError(_SI_SDR_DISABLED_HINT)
        return _numpy(si_sdr(
            reference=self.speech_source,
            estimation=self.speech_prediction_selection,
            allow_float32=si_sdr_allow_float32(
                self.speech_source,
                self.speech_prediction_selection)))

    def _metric_groups(self):
        return [
            (_pesq_available(), ('pesq',)),
            (True, ('stoi', 'mir_eval_sdr', 'mir_eval_sir',
                    'mir_eval_sar', 'mir_eval_selection', 'srmr')),
            (self.enable_si_sdr, ('si_sdr',)),
            (self._has_contribution_signals,
             ('invasive_sdr', 'invasive_snr', 'invasive_sir')),
        ]
