"""Separation quality of the complex Bingham mixture on the eight 4.8 s
dummy utterances that ``chip_smoke.py`` separates.

    python -m pb_bss_tpu_torch.testing.cbmm_quality --device cpu

Two recipes, each 20 EM iterations, K=3, GEV+BAN beamforming after the
DHTV alignment (the ``separate_batch`` pipeline):

* ``random``: the ``separate_batch(model='cbmm')`` pipeline from a
  random initialization. A random start separates poorly with the
  Bingham mixture: the control.
* ``warm``: the CBMM fit from the posteriors of a 20-iteration cACGMM fit
  (``CBMMTrainer().fit_predict(Y, initialization=<cACGMM posteriors>)``),
  the JAX package's warm-start recipe, which does separate.

Both start from the same random initialization, drawn on the CPU from a
seed, so a run on the card starts where the CPU run starts. Prints the
per-frequency SI-SDR (``evaluation.si_sdr_stft``) of the best estimate
per speaker, the batch means and the worst single estimate;
``chip_smoke.py`` holds the card's warm-recipe scores to floors set
between the CPU's control and warm scores.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ['RECIPES', 'cbmm_quality', 'utterances', 'MEAN_FLOOR_DB',
           'SINGLE_FLOOR_DB', 'WARM_MEAN_FLOOR_DB', 'WARM_SINGLE_FLOOR_DB']

RECIPES = ('random', 'warm')

# quality floors of chip_smoke.py's CBMM phase (per-frequency SI-SDR of the
# best estimate per speaker; tests/test_torch_pipeline.py::
# test_cbmm_quality_on_the_smoke_utterances, slow tier, prints the numbers
# behind them and holds the CPU to the same floors).
# separate_batch(model='cbmm') from its random initialization: a random
# start separates poorly with the Bingham mixture (the JAX package measured
# -2.6 / -2.4 dB invasive at 4 iterations,
# tests/test_models/test_head_to_head.py), so these only catch a broken
# path, below the port's CPU numbers over its 7 finite utterances, -1.44 /
# 3.03 dB, worst -8.29 (JAX's separate(model='cbmm'): 3 finite, -3.09 /
# 1.79, 5.38 / 5.85, -1.69 / 5.03 dB; measured on the CPU).
MEAN_FLOOR_DB = -8.0
SINGLE_FLOOR_DB = -25.0
# the warm recipe: between its control (the same pipeline from the random
# start) and its CPU numbers (``--device cpu``: warm 3.88 / 6.68 dB, worst
# -4.33; control -1.02 / 2.67 dB, worst -6.91); the smoke runs the control
# on the card too, to show that the floors part the two there.
WARM_MEAN_FLOOR_DB = 2.0
WARM_SINGLE_FLOOR_DB = -8.0
_ITERATIONS = 20
_NUM_CLASSES = 3
_STFT = (512, 128)


def utterances(seeds=range(8)):
    """(observations (B, D, N) float32, reference-channel speech images
    (B, S, N) float64) of ``low_reverberation_data(seed)``."""
    from .dummy_data import low_reverberation_data
    data = [low_reverberation_data(seed=s) for s in seeds]
    return (torch.as_tensor(np.stack([d['observation'] for d in data]),
                            dtype=torch.float32),
            torch.as_tensor(np.stack([d['speech_image'][:, 0]
                                      for d in data]), dtype=torch.float64))


def cbmm_quality(observations, images, recipe):
    """Separate with ``recipe`` on the observations' device and score.

    Args:
        observations: (B, D, N) float time signals.
        images: (B, S, N) reference-channel speech images.
    Returns:
        (B, S) SI-SDR in dB of the best estimate per speaker.
    """
    from ..evaluation import si_sdr_stft
    from ..models.cacgmm import CACGMMTrainer
    from ..pipeline import _init_shape, _random_affiliation, _separate
    from ..transform import stft

    if recipe not in RECIPES:
        raise ValueError(recipe)
    B = observations.shape[0]
    shape = _init_shape(observations[0], _NUM_CLASSES, *_STFT)
    generator = torch.Generator().manual_seed(0)
    init = torch.stack([
        _random_affiliation(generator, shape, torch.float32, 'cpu')
        for _ in range(B)]).to(observations.device)
    if recipe == 'warm':
        Y = stft(observations, *_STFT).permute(0, 3, 2, 1)  # (B, F, T, D)
        init = CACGMMTrainer().fit_predict(Y, initialization=init,
                                           iterations=_ITERATIONS)
    out = _separate(observations, init, iterations=_ITERATIONS,
                    stft_size=_STFT[0], stft_shift=_STFT[1],
                    beamformer='gev+ban', reference_channel=0,
                    eigh_sweeps=None, model='cbmm', refine=None,
                    refine_iterations=0)
    return si_sdr_stft(images[:, :, None].cpu().double(),
                       out.cpu().double()[:, None]).max(-1).values


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    observations, images = utterances()
    for recipe in RECIPES:
        scores = cbmm_quality(observations.to(args.device), images, recipe)
        print(f'{recipe}: per speaker {scores.numpy().round(2).tolist()}; '
              f'batch means {scores.mean(0).numpy().round(2).tolist()}; '
              f'worst {scores.min().item():.2f} dB')


if __name__ == '__main__':
    main()
