"""Driver of ``pb_bss_tpu_torch.pipeline.separate_batch``: offline
separation of batches of multichannel recordings, back to back.

Set-up puts the traffic's pool of batches on the card. Call ``i``
separates batch ``i % pool_batches`` with the EM initialization drawn
from a generator seeded by the run's seed and ``i``. A capturing call
keeps what the timed path produced at each stage for ``check_rows``
recordings of the batch drawn from the seed: the STFT, the EM's
affiliations, the beamformed spectra before the iSTFT, and the returned
signals.

The check follows the program stage by stage, because the EM is
chaotic: from the same initialization, float32 and float64 fits part in
a few bins, and a whole pipeline from the reference's own affiliations
would compare different local optima there. So each stage is held
against the reference from the stage's own inputs:

* ``stft_gap``: the program's STFT against the reference's of the same
  observations, relative Frobenius error, the worst utterance;
* ``em_gap``: the program's affiliations against the reference's EM
  from the same initialization on the reference's STFT: the largest
  gap in each (recording, bin), and of these the ``QUANTILE`` over all
  the call's checked recordings and bins;
* ``extract_gap``: the program's beamformed spectra against the
  reference's DHTV, PSDs, GEV+BAN and output from the program's
  affiliations, each bin turned by the phase that fits it best: the
  relative error of each (recording, class, bin), and of these the
  ``QUANTILE`` over the call. A phase per bin, because a GEV vector's
  phase is arbitrary and the phase chaining over the bins carries the
  rounding of every lower bin into the higher ones (the chaining
  itself is therefore not compared). A high quantile and not the
  largest, because in a few places float32 and float64 part by nature:
  the EM is chaotic in a few bins, and where DHTV's greedy scores
  nearly tie its choice flips, in one recording, over a whole band of
  bins, whose error is then of order one (the error over all bins is
  logged beside it). Over the whole call, because such a band can be
  a tenth of one recording's bins but is a small share of the call's.
  A fault in more than a tenth of the bins, or of the recordings,
  reads as that fault;
* ``istft_gap``: the returned signals against the reference's iSTFT of
  the program's beamformed spectra, relative error, the worst class.
"""
from __future__ import annotations

import numpy as np

from sepbench import reference
from sepbench.harness import counts, runner, traffic as traffic_module

CAPTURES = {
    'stft': 'pb_bss_tpu_torch.pipeline.stft',
    'affiliation': ('pb_bss_tpu_torch.models.cacgmm.CACGMMTrainer'
                    '.fit_predict_model'),
    'spectra': 'pb_bss_tpu_torch.pipeline.istft',
}
ENTRY = 'pb_bss_tpu_torch.pipeline.separate_batch'
# the share of the bins below a per-bin gap that em_gap and extract_gap
# read
QUANTILE = 0.9


def call_seed(seed, index):
    """The EM generator's seed of call ``index`` of a run."""
    return (int(seed) * 1_000_003 + int(index)) % 2 ** 63


class Driver:
    def __init__(self, torch, config, traffic, seed, device,
                 check_rows=None):
        self.torch = torch
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.batch = traffic['batch']
        self.check_rows = check_rows
        self.current = None
        self.rows = None
        self.pool = None

    # -- set-up -----------------------------------------------------------

    def setup(self):
        pool = traffic_module.pool(self.config, self.traffic, self.seed)
        self.pool = self.torch.as_tensor(pool, device=self.device)

    def install(self, wrappers):
        """Wrap the capture points; they keep tensors only during a
        capturing call."""
        def keep(name, pick):
            def make(original):
                def captured(*args, **kwargs):
                    result = original(*args, **kwargs)
                    if self.current is not None:
                        kept = pick(args, result)
                        # a batch of another size is kept whole: the
                        # check then reads it as wrong
                        if kept.shape[0] == self.batch:
                            kept = kept.index_select(0, self.rows)
                        self.current[name] = kept
                    return result
                return captured
            return make
        wrappers.wrap(CAPTURES['stft'], keep('stft', lambda a, r: r))
        wrappers.wrap(CAPTURES['affiliation'],
                      keep('affiliation', lambda a, r: r[1]))
        wrappers.wrap(CAPTURES['spectra'], keep('spectra', lambda a, r: a[0]))
        from sepbench.harness.spans import resolve
        owner, attr = resolve(ENTRY)
        self.entry = lambda: getattr(owner, attr)

    def work_per_call(self):
        """Seconds of audio one call separates."""
        return self.batch * self.config['samples'] \
            / self.config['sample_rate']

    # -- the timed path ---------------------------------------------------

    def sampled(self, index):
        """The recordings of call ``index`` that its check compares."""
        return runner.sample_rows(self.seed, index, self.batch,
                                  self.check_rows)

    def call(self, index, capture=False):
        torch = self.torch
        self.current = None
        if capture:
            rows = self.sampled(index)
            self.rows = torch.as_tensor(rows, device=self.device)
            self.current = {'rows': rows}
        generator = torch.Generator(self.device).manual_seed(
            call_seed(self.seed, index))
        c = self.config
        out = self.entry()(
            self.pool[index % len(self.pool)],
            num_classes=c['num_classes'], iterations=c['iterations'],
            stft_size=c['stft_size'], stft_shift=c['stft_shift'],
            beamformer=c['beamformer'], model=c['model'],
            generator=generator)
        captured, self.current = self.current, None
        if captured is not None:
            captured['signals'] = out.index_select(0, self.rows) \
                if out.shape[0] == self.batch else out
        return out, captured

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
        spectra = reference.extract(spectrum, affiliation, 'tf32')
        signals = reference.istft(spectra, size, shift, obs.shape[-1],
                                  'tf32')
        return {'rows': rows, 'stft': spectrum, 'affiliation': affiliation,
                'spectra': spectra, 'signals': signals}

    # -- the check --------------------------------------------------------

    def reference_inputs(self, index, rows):
        """(observations, initialization) of the recordings ``rows`` of
        call ``index``."""
        obs = self.pool[index % len(self.pool)]
        c = self.config
        F = c['stft_size'] // 2 + 1
        init = reference.initialization(
            call_seed(self.seed, index), obs.shape[0], F, c['num_classes'],
            counts.frames(c), self.device, rows=rows)
        return obs[rows], init

    def check_call(self, index, captured):
        torch = self.torch
        c = self.config
        size, shift = c['stft_size'], c['stft_shift']
        obs, init = self.reference_inputs(index, captured['rows'])
        spectrum = reference.stft(obs, size, shift)  # (R, D, T, F)
        out = {}
        got = captured.get('stft')
        out['stft_gap'] = _worst_relative(got, spectrum, (1, 2, 3))
        per_utterance = spectrum[0, 0].numel() * c['num_classes'] \
            * c['channels'] * 16
        block = max(1, int(2e9 // per_utterance))
        affiliation = reference.cacgmm_em(
            spectrum, init, c['iterations'], block=block)
        got = captured.get('affiliation')
        if got is None or got.shape != affiliation.shape:
            out['em_gap'] = np.inf
        else:
            gap = (got.to(affiliation.dtype) - affiliation).abs() \
                .amax((-1, -2))  # (R, F)
            out['em_gap'] = float(gap.flatten().quantile(QUANTILE))
        del affiliation
        got = captured.get('spectra')
        aff = captured.get('affiliation')
        if got is None or aff is None or aff.shape[0] != obs.shape[0]:
            out['extract_gap'] = np.inf
        else:
            want = reference.extract(spectrum, aff)
            per_bin, out['extract_gap_energy'] = \
                _worst_phase_relative(got, want)
            out['extract_gap'] = np.inf if per_bin is None \
                else float(per_bin.flatten().quantile(QUANTILE))
        signals = captured.get('signals')
        if got is None or signals is None:
            out['istft_gap'] = np.inf
        else:
            want = reference.istft(got, size, shift, obs.shape[-1])
            out['istft_gap'] = _worst_relative(signals, want, (-1,))
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        return out


def _worst_relative(got, want, dims):
    if got is None or tuple(got.shape) != tuple(want.shape):
        return np.inf
    diff = (got.to(want.dtype) - want).abs() ** 2
    ref = want.abs() ** 2
    return float((diff.sum(dims) / ref.sum(dims)).sqrt().max())


def _worst_phase_relative(got, want):
    """Spectra (R, K, T, F), each bin of ``got`` against ``want`` turned
    by the phase that fits it best: (each bin's relative error (R, K, F),
    the worst relative error over all bins of an (utterance, class))."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return None, np.inf
    got = got.to(want.dtype)
    inner = (want.conj() * got).sum(-2)  # (B, K, F)
    phase = inner / inner.abs().clamp_min(1e-300)
    diff = (got - phase[..., None, :] * want).abs() ** 2
    ref = want.abs() ** 2
    per_bin = (diff.sum(-2) / ref.sum(-2)).sqrt()  # (B, K, F)
    whole = (diff.sum((-1, -2)) / ref.sum((-1, -2))).sqrt()
    return per_bin, float(whole.max())


__all__ = ['Driver', 'call_seed', 'CAPTURES', 'ENTRY']
