"""Driver of ``pb_bss_tpu_torch.evaluation.OutputMetricsBatch``: scoring
a separated corpus, batch after batch.

Set-up makes, from the seed, each recording's two clean sources and
three estimates on the card: each speaker's image at channel 0 with a
share of the other speaker's image and of the noise, and a noise
estimate with a share of both speakers (the K+1 routing of a mixture
model's noise class). The shares are drawn per recording. Call ``i``
scores batch ``i % pool_batches`` and reads BSS-Eval's SDR, SIR and SAR
and the STOI of its selection, as host arrays.

The check scores ``check_rows`` utterances of each sampled call, drawn
from the seed, again with the float64 reference (BSS-Eval v3 over every
(estimate, source) pair, the K+1 selection by the largest mean SIR,
STOI) and gives: ``selection_gap``, the (utterance, source) pairs
routed to another estimate than the reference routes them (exact:
limit 0); and ``sdr_gap``, ``sir_gap``, ``sar_gap`` (dB) and
``stoi_gap``, each the largest gap over the utterances and sources
between what the program reports and what the reference gives for the
same (estimate, source) pair, the program's own selection. The cell
file says which of them are compared.
"""
from __future__ import annotations

import numpy as np

from sepbench.harness import runner, traffic as traffic_module
from sepbench.reference import bss_eval, stoi

ENTRY = 'pb_bss_tpu_torch.evaluation.OutputMetricsBatch'
READ = ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar', 'stoi')


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

    def setup(self):
        t, c = self.traffic, self.config
        count = t['pool_batches'] * t['batch']
        seeds = traffic_module.scenario_seeds(self.seed, count)
        rng = np.random.default_rng(seeds)
        low, high = t['leak']
        kwargs = traffic_module.scenario_kwargs(c)
        sources, estimates = [], []

        def pick(scene):
            return (scene['speech_image'][:, 0], scene['noise_image'][0],
                    scene['speech_source'])
        for image, noise, source in traffic_module.scenarios(
                seeds, pick, **kwargs):
            a, b, n = rng.uniform(low, high, size=(3, 2))
            estimates.append(np.stack([
                image[0] + a[0] * image[1] + b[0] * noise,
                image[1] + a[1] * image[0] + b[1] * noise,
                noise + n[0] * image[0] + n[1] * image[1]])
                .astype(np.float32))
            sources.append(source.astype(np.float32))
        shape = (t['pool_batches'], t['batch'])
        self.sources = self.torch.as_tensor(
            np.stack(sources).reshape(*shape, *sources[0].shape),
            dtype=self.torch.float32, device=self.device)
        self.estimates = self.torch.as_tensor(
            np.stack(estimates).reshape(*shape, *estimates[0].shape),
            dtype=self.torch.float32, device=self.device)

    def install(self, wrappers):
        from sepbench.harness.spans import resolve
        owner, attr = resolve(ENTRY)
        self.entry = lambda: getattr(owner, attr)

    def work_per_call(self):
        """Seconds of audio one call scores."""
        return self.batch * self.config['samples'] \
            / self.config['sample_rate']

    def call(self, index, capture=False):
        k = index % len(self.sources)
        metrics = self.entry()(
            self.estimates[k], self.sources[k],
            sample_rate=self.config['sample_rate'], device=self.device.type)
        values = {name: getattr(metrics, name) for name in READ}
        # (batch, metric, source): a row per utterance
        out = self.torch.as_tensor(np.stack([values[n] for n in READ], 1))
        if not capture:
            return out, None
        values['selection'] = np.asarray(metrics.mir_eval_selection)
        rows = runner.sample_rows(self.seed, index, self.batch,
                                  self.check_rows)
        captured = {name: np.asarray(v)[rows] for name, v in values.items()}
        captured['rows'] = rows
        return out, captured

    def check_call(self, index, captured):
        k = index % len(self.sources)
        rows = captured['rows']
        sources = self.sources[k][rows].double().cpu().numpy()
        estimates = self.estimates[k][rows].double().cpu().numpy()
        selection = np.asarray(captured['selection'])
        if selection.shape != (len(sources), sources.shape[1]):
            return {'selection_gap': np.inf, 'sdr_gap': np.inf,
                    'sir_gap': np.inf, 'sar_gap': np.inf,
                    'stoi_gap': np.inf}
        sr = self.config['sample_rate']
        want = {name: [] for name in READ}
        moved = 0
        for src, est, chosen in zip(sources, estimates, selection):
            sdr, sir, sar, best = bss_eval.criteria(src, est)
            moved += int((best != chosen).sum())
            pair = (chosen, np.arange(len(src)))
            want['mir_eval_sdr'].append(sdr[pair])
            want['mir_eval_sir'].append(sir[pair])
            want['mir_eval_sar'].append(sar[pair])
            want['stoi'].append(stoi.stoi(src, est[chosen], sr))
        out = {'selection_gap': float(moved)}
        for name, key in (('sdr_gap', 'mir_eval_sdr'),
                          ('sir_gap', 'mir_eval_sir'),
                          ('sar_gap', 'mir_eval_sar'),
                          ('stoi_gap', 'stoi')):
            got = np.asarray(captured[key], np.float64)
            ref = np.stack(want[key])
            out[name] = float(np.abs(got - ref).max()) \
                if got.shape == ref.shape else np.inf
        return out


__all__ = ['Driver', 'ENTRY']
