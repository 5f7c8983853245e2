"""Separation quality of the frequency-constant cACGMM fit with an inline
permutation aligner, on one 4.8 s dummy utterance.

    python -m pb_bss_tpu_torch.testing.inline_quality --device cpu

The fit (``weight_constant_axis=(-3, -1)``, 20 iterations, K=3) aligns
the classes across frequency inside the EM, so its masks are applied at
the reference channel with no alignment afterwards. Prints the SI-SDR
(``evaluation.si_sdr_stft``) of the best estimate per speaker for the
Greedy and the DHTV aligner, and for the control: the same fit with no
aligner, whose classes stay permuted across frequency. The
initialization is drawn on the CPU from a seed, so a run on the card
starts where the CPU run starts; ``chip_smoke.py`` holds the card's
scores to floors set between the CPU's control and aligned scores.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ['ALIGNERS', 'CONTROL', 'inline_aligner_quality', 'utterance']

ALIGNERS = ('greedy', 'dhtv')
CONTROL = 'none'  # the fit without an inline aligner
_ITERATIONS = 20
_NUM_CLASSES = 3
_SEED = 0


def _aligner(name):
    from ..permutation_alignment import (
        DHTVPermutationAlignment,
        GreedyPermutationAlignment,
    )
    return {'greedy': GreedyPermutationAlignment('cos'),
            'dhtv': DHTVPermutationAlignment.from_stft_size(512),
            CONTROL: None}[name]


def utterance():
    """(observation (D, N) float32, reference-channel speech images
    (S, N) float64) of ``low_reverberation_data(0)``."""
    from .dummy_data import low_reverberation_data
    data = low_reverberation_data(_SEED)
    return (torch.as_tensor(np.asarray(data['observation'], np.float32)),
            torch.as_tensor(np.asarray(data['speech_image'][:, 0],
                                       np.float64)))


def inline_aligner_quality(observation, images, aligner):
    """Fit with the inline ``aligner`` ('greedy', 'dhtv' or the control
    'none') on the observation's device and score the masks at the
    reference channel (channel 0).

    Args:
        observation: (D, N) float time signal.
        images: (S, N) reference-channel speech images.
    Returns:
        (SI-SDR (S,) in dB of the best estimate per speaker, the fitted
        affiliation (F, K, T)).
    """
    from ..evaluation import si_sdr_stft
    from ..models.cacgmm import CACGMMTrainer
    from ..transform import istft, stft

    Observation = stft(observation)  # (D, T, F)
    Y = Observation.permute(2, 1, 0)  # (F, T, D)
    F, T, _ = Y.shape
    init = torch.rand((F, _NUM_CLASSES, T),
                      generator=torch.Generator().manual_seed(_SEED))
    init = (init / init.sum(-2, keepdim=True)).to(observation.device)
    affiliation = CACGMMTrainer().fit_predict(
        Y, initialization=init, iterations=_ITERATIONS,
        weight_constant_axis=(-3, -1),
        inline_permutation_aligner=_aligner(aligner))
    masked = affiliation.permute(1, 2, 0) * Observation[0]  # (K, T, F)
    estimates = istft(masked, num_samples=observation.shape[-1])
    scores = si_sdr_stft(images[:, None].cpu().double(),
                         estimates[None].cpu().double())  # (S, K)
    return scores.max(-1).values, affiliation


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    observation, images = utterance()
    for name in ALIGNERS + (CONTROL,):
        scores, _ = inline_aligner_quality(
            observation.to(args.device), images, name)
        print(f'{name}: SI-SDR per speaker (dB)',
              [round(float(s), 2) for s in scores])


if __name__ == '__main__':
    main()
