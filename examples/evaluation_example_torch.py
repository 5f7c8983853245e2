"""Device-first evaluation example on the PyTorch port
(``pb_bss_tpu_torch``; the counterpart of evaluation_example.py).

Separates a batch of synthetic mixtures with ``separate_batch`` and
scores them three ways:

1. the single-utterance ``OutputMetrics`` facade (on the card its
   BSS-Eval + STOI run as one fused device pass; on the CPU the host
   float64 oracles),
2. the batched ``OutputMetricsBatch`` (whole-batch BSS-Eval + STOI in
   one pass, SRMR), and
3. the batched ``InputMetricsBatch`` for the unprocessed mixtures,
   giving the improvement per metric.

On the card ``separate_batch`` runs the whole-fit EM kernel once and
the GEV kernel once; ``--device cpu`` runs their plain twins.

Run: python examples/evaluation_example_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

from pb_bss_tpu_torch.evaluation import (
    InputMetricsBatch,
    OutputMetrics,
    OutputMetricsBatch,
)
from pb_bss_tpu_torch.pipeline import separate_batch
from pb_bss_tpu_torch.testing.dummy_data import low_reverberation_data


def _host(x):
    """A metric as a host array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def main(iterations=20, batch=4, device='cuda'):
    device = torch.device(device)
    # a small batch of copies of the synthetic reverberant 2-speaker
    # scene with different noise (stand-in for a dataset shard)
    rng = np.random.default_rng(0)
    base = low_reverberation_data(seed=0)
    obs0 = base['audio_data']['observation']
    sources = base['audio_data']['speech_source']
    B = batch
    observations = torch.as_tensor(np.stack([
        obs0 + 0.01 * rng.standard_normal(obs0.shape)
        for _ in range(B)
    ]), dtype=torch.float32, device=device)
    batch_sources = np.broadcast_to(sources, (B,) + sources.shape)

    waves = separate_batch(
        observations, num_classes=3, iterations=iterations,
        beamformer='gev+ban',
        generator=torch.Generator(device).manual_seed(0))
    print('separated:', tuple(waves.shape))      # (B, K, N)

    # --- input metrics of the raw mixtures (batched) ----------------
    input_metrics = InputMetricsBatch(
        observation=observations,
        speech_source=batch_sources,
        sample_rate=8000,
        device=device,
    )
    in_sdr = _host(input_metrics['mir_eval_sdr'])     # (B, K, D)

    # --- output metrics (batched, one fused device pass) ------------
    output_metrics = OutputMetricsBatch(
        speech_prediction=waves,
        speech_source=batch_sources,
        sample_rate=8000,
        device=device,
    )
    scores = {k: _host(v) for k, v in output_metrics.as_dict().items()}
    gain = scores['mir_eval_sdr'] - in_sdr[..., 0]
    print('SDR gain over channel 0 (dB, per utterance x speaker):')
    print(np.round(gain, 2))
    print('STOI:', np.round(scores['stoi'], 3))
    print('SRMR:', np.round(scores['srmr'], 2))

    # --- the same numbers through the single-utterance facade -------
    single = OutputMetrics(
        speech_prediction=waves[0],
        speech_source=sources,
        sample_rate=8000,
        device=device,
    )
    print('utterance 0 via OutputMetrics:',
          np.round(_host(single.mir_eval_sdr), 2))


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--iterations', type=int, default=20)
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    main(iterations=args.iterations, batch=args.batch, device=args.device)
