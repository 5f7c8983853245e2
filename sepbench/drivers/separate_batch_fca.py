"""Driver of ``pb_bss_tpu_torch.pipeline.separate_batch`` with the FCA
refinement (``refine='fca'``): offline separation of batches of
multichannel recordings, back to back, the cACGMM's aligned masks
refined by an FCA fit whose Wiener image at the reference channel is
the output.

The timed path is :mod:`separate_batch`'s with the configuration's
``refine``, ``refine_iterations`` and ``reference_channel``. A
capturing call keeps, for ``check_rows`` recordings of the batch drawn
from the seed: the STFT, the EM's affiliations, the masks the FCA fit
starts from (its ``initialization``, folded as (B F, K, T)), the
refined spectra before the iSTFT and the returned signals.

The check follows the program stage by stage, each stage held against
the float64 reference from the stage's own inputs (the EM is chaotic,
and FCA, warm-started from its masks, inherits that):

* ``stft_gap`` and ``em_gap`` as in :mod:`separate_batch`;
* ``mask_gap``: the masks the fit starts from against the reference
  DHTV of the program's affiliations: the largest gap in each
  (recording, bin), and of these the ``QUANTILE`` over the call;
* ``fca_gap``: the refined spectra against the reference FCA
  (``sepbench/reference/fca.py``) fitted from the program's masks on
  the reference's STFT: the relative error of each (recording, class,
  bin), of these the ``QUANTILE`` over the call's recordings and bins
  for each class, and the largest of the classes. A high quantile and
  not the largest, because in a few bins an IP row's system is
  ill-conditioned: there the float32 solve leaves a residual at the
  program's gate and takes the pseudo-inverse, and the fit follows
  another path from then on. A quantile for each class, so that a
  fault in more than a tenth of one class's bins reads as that fault.
  The worst whole-utterance error of a class is logged beside it
  (``fca_gap_energy``);
* ``istft_gap`` as in :mod:`separate_batch`.
"""
from __future__ import annotations

import functools

import numpy as np

from sepbench import reference
from sepbench.harness import runner
from sepbench.reference.fca import fca as reference_fca
from sepbench.reference.precision import real_dtype

base = runner.load_module('drivers', 'separate_batch')
QUANTILE = base.QUANTILE
FIT = 'pb_bss_tpu_torch.models.fca.FCATrainer.fit'


class Driver(base.Driver):

    def install(self, wrappers):
        super().install(wrappers)
        c = self.config
        entry = self.entry
        self.entry = lambda: functools.partial(
            entry(), refine=c['refine'],
            refine_iterations=c['refine_iterations'],
            reference_channel=c['reference_channel'])
        bins = c['stft_size'] // 2 + 1

        def make(original):
            def captured(*args, **kwargs):
                if self.current is not None:
                    masks = kwargs.get('initialization')
                    if masks is None and len(args) > 2:
                        masks = args[2]
                    # (B F, K, T) -> the sampled rows' (R, F, K, T); a
                    # fold of another size is kept whole, and the check
                    # reads it as wrong
                    if masks.shape[0] == self.batch * bins:
                        masks = masks.reshape(self.batch, bins,
                                              *masks.shape[1:])
                        masks = masks.index_select(0, self.rows)
                    self.current['masks'] = masks
                return original(*args, **kwargs)
            return captured
        wrappers.wrap(FIT, make)

    def control(self, index):
        """What the reference, in TF32, gives in the program's place for
        call ``index``: the control of the check."""
        c = self.config
        size, shift = c['stft_size'], c['stft_shift']
        rows = self.sampled(index)
        obs, init = self.reference_inputs(index, rows)
        spectrum = reference.stft(obs, size, shift, 'tf32')
        affiliation = reference.cacgmm_em(spectrum, init, c['iterations'],
                                          'tf32')
        masks = _aligned(affiliation, 'tf32')  # (R, K, F, T)
        spectra = reference_fca(spectrum, masks, c['refine_iterations'],
                                'tf32',
                                reference_channel=c['reference_channel'])
        signals = reference.istft(spectra, size, shift, obs.shape[-1],
                                  'tf32')
        return {'rows': rows, 'stft': spectrum, 'affiliation': affiliation,
                'masks': masks.transpose(1, 2), 'spectra': spectra,
                'signals': signals}

    def check_call(self, index, captured):
        c = self.config
        size, shift = c['stft_size'], c['stft_shift']
        # stft_gap and em_gap as the base driver reads them; given no
        # spectra it checks no extraction (this path has none)
        out = super().check_call(index, dict(captured, spectra=None))
        del out['extract_gap'], out['istft_gap']
        obs, _ = self.reference_inputs(index, captured['rows'])
        spectrum = reference.stft(obs, size, shift)  # (R, D, T, F)
        aff = captured.get('affiliation')
        masks = captured.get('masks')  # (R, F, K, T)
        if aff is None or aff.shape[0] != obs.shape[0]:
            out['mask_gap'] = np.inf
        else:
            out['mask_gap'] = _quantile_gap(
                masks, _aligned(aff).transpose(1, 2), (-1, -2))
        got = captured.get('spectra')  # (R, K, T, F)
        if masks is None or aff is None or got is None \
                or tuple(masks.shape) != tuple(aff.shape):
            out['fca_gap'] = out['fca_gap_energy'] = np.inf
        else:
            want = reference_fca(spectrum, masks.transpose(1, 2),
                                 c['refine_iterations'],
                                 reference_channel=c['reference_channel'])
            out['fca_gap'], out['fca_gap_energy'] = fca_gap(got, want)
            del want
        signals = captured.get('signals')
        if got is None or signals is None:
            out['istft_gap'] = np.inf
        else:
            want = reference.istft(got, size, shift, obs.shape[-1])
            out['istft_gap'] = base._worst_relative(signals, want, (-1,))
        if self.device.type == 'cuda':
            self.torch.cuda.empty_cache()
        return out


def _aligned(affiliation, precision='float64'):
    """The reference DHTV's masks (R, K, F, T) of affiliations
    (R, F, K, T)."""
    masks = affiliation.transpose(1, 2).to(real_dtype(precision))
    return reference.apply_mapping(
        masks, reference.dhtv_mapping(masks, precision))


def _quantile_gap(got, want, dims):
    """The ``QUANTILE`` over the call of the largest gap over ``dims``
    of each remaining index (``em_gap``'s statistic); inf where the
    shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return np.inf
    gap = (got.to(want.dtype) - want).abs().amax(dims)
    return float(gap.flatten().quantile(QUANTILE))


def fca_gap(got, want):
    """(``fca_gap``, ``fca_gap_energy``) of spectra (R, K, T, F) against
    the reference's: the relative error of each (recording, class, bin),
    its ``QUANTILE`` over the recordings and bins of each class and the
    largest over the classes (a bin that is not finite on either side
    counts as the largest error); the worst relative error over all bins
    of a (recording, class). Both inf where the shapes differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return np.inf, np.inf
    diff = (got.to(want.dtype) - want).abs() ** 2
    ref = want.abs() ** 2
    # a non-finite bin, on either side, counts as the largest error
    per_bin = (diff.sum(-2) / ref.sum(-2)).sqrt().nan_to_num(
        nan=np.inf)  # (R, K, F)
    whole = (diff.sum((-1, -2)) / ref.sum((-1, -2))).sqrt()
    by_class = per_bin.transpose(0, 1).flatten(1).quantile(QUANTILE, 1)
    return float(by_class.max()), float(whole.max())


__all__ = ['Driver', 'FIT', 'QUANTILE', 'fca_gap']
