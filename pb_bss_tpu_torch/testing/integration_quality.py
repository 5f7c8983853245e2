"""Separation quality of the integration models on the eight 4.8 s dummy
utterances that ``chip_smoke.py`` separates.

    python -m pb_bss_tpu_torch.testing.integration_quality --device cpu

The integration models need an embedding per time-frequency bin (a
Deep-Clustering network's, in their users' pipelines). Here it is made
from the oracle: the dominant source of each bin (the largest of the two
speech images and the noise image at the reference channel, by STFT
power) picks one of three seeded unit class centres in E=20 dimensions,
plus seeded Gaussian noise, normalized to unit length as a
Deep-Clustering network's output is. The control is the same fit with
embeddings of noise only, which carry no class information.

As in a Deep-Clustering pipeline, the fit starts from a spherical k-means
of the embeddings (:func:`kmeans_initialization`): from a random
affiliation the global vMF classes start alike and the EM settles with
one class over two sources (decision accuracy ~0.6 in both packages on
these utterances). ``VMFCACGMMTrainer().fit_predict`` (K=3, 20
iterations, batched over the eight utterances) needs no permutation
alignment: the spectral model is global over the bins, so a class means
the same source at every frequency. Two metrics: the decision accuracy
against the dominant source (the best of the K! class mappings per
utterance), and the per-frequency SI-SDR (``evaluation.si_sdr_stft``) of
the best mask estimate per speaker at the reference channel. The
embeddings are drawn on the CPU from seeds, so a run on the card starts
where the CPU run starts; ``chip_smoke.py`` and the slow CPU test
(``tests/test_torch_vmfcacgmm.py``) hold the scores to the floors below.
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

__all__ = ['EMBEDDINGS', 'embeddings', 'kmeans_initialization',
           'integration_quality', 'score', 'passes', 'utterances',
           'decision_accuracy', 'dominant_source', 'ACCURACY_FLOOR',
           'MEAN_FLOOR_DB', 'SINGLE_FLOOR_DB', 'EMBEDDING_DIM', 'NOISE']

EMBEDDINGS = ('oracle', 'random')  # the recipe and its control
EMBEDDING_DIM = 20
NOISE = 0.3  # std of the embedding noise per dimension, before the norm
# floors, between the control and the oracle-embedding fit on the CPU
# (``--device cpu``): oracle accuracy 0.990-0.992 per utterance, SI-SDR
# batch means 7.53 / 14.57 dB, worst 2.58; control accuracy 0.341-0.353,
# -4.96 / 3.73 dB, worst -13.22 (the port; JAX's trainer on the same
# input: tests/test_torch_vmfcacgmm.py::test_integration_quality_on_the_
# smoke_utterances, slow tier)
ACCURACY_FLOOR = 0.9  # mean decision accuracy over the utterances
MEAN_FLOOR_DB = 4.0
SINGLE_FLOOR_DB = -4.0
_ITERATIONS = 20
_NUM_CLASSES = 3
_SEED = 0


def utterances(seeds=range(8)):
    """(observations (B, D, N) float32, reference-channel speech images
    (B, S, N) float64, reference-channel noise images (B, N) float64) of
    ``low_reverberation_data(seed)``."""
    from .dummy_data import low_reverberation_data
    data = [low_reverberation_data(seed=s) for s in seeds]
    return (torch.as_tensor(np.stack([d['observation'] for d in data]),
                            dtype=torch.float32),
            torch.as_tensor(np.stack([d['speech_image'][:, 0]
                                      for d in data]), dtype=torch.float64),
            torch.as_tensor(np.stack([d['noise_image'][0] for d in data]),
                            dtype=torch.float64))


def dominant_source(images, noise_images):
    """(B, F, T) index of the largest of the speech images and the noise
    image by STFT power."""
    from ..transform import stft
    sources = torch.cat([images, noise_images[:, None]], 1)  # (B, 3, N)
    return (stft(sources).abs() ** 2).argmax(1).transpose(-1, -2)


def embeddings(images, noise_images, kind='oracle', seed=_SEED):
    """(B, F, T, E) float32 unit-norm embeddings on the CPU: a seeded
    class centre of the dominant source per bin plus noise
    (``'oracle'``), or the noise alone (``'random'``, the control)."""
    if kind not in EMBEDDINGS:
        raise ValueError(kind)
    dominant = dominant_source(images, noise_images).numpy()
    rng = np.random.RandomState(seed)
    centres = rng.randn(_NUM_CLASSES, EMBEDDING_DIM)
    centres /= np.linalg.norm(centres, axis=-1, keepdims=True)
    emb = NOISE * rng.randn(*dominant.shape, EMBEDDING_DIM)
    if kind == 'oracle':
        emb = emb + centres[dominant]
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return torch.as_tensor(emb, dtype=torch.float32)


def kmeans_initialization(embedding, num_classes=_NUM_CLASSES,
                          iterations=10, smooth=0.1):
    """(B, F, K, T) initial affiliation of each utterance from a spherical
    k-means of its (F * T) unit embeddings: seeds by farthest point (the
    first frame, then each frame least like the seeds so far), then
    ``iterations`` Lloyd steps; the hard labels smoothed by ``smooth``."""
    B, F, T, E = embedding.shape
    x = embedding.reshape(B, F * T, E)
    out = []
    for xb in x:
        seeds = [xb[0]]
        for _ in range(num_classes - 1):
            likeness = torch.stack([xb @ c for c in seeds]).max(0).values
            seeds.append(xb[likeness.argmin()])
        centres = torch.stack(seeds)
        for _ in range(iterations):
            label = (xb @ centres.T).argmax(-1)
            centres = torch.stack([xb[label == k].sum(0)
                                   for k in range(num_classes)])
            centres = centres / torch.clamp(
                centres.norm(dim=-1, keepdim=True), min=1e-30)
        label = (xb @ centres.T).argmax(-1)
        a = torch.nn.functional.one_hot(label, num_classes).to(xb.dtype)
        out.append((a * (1 - smooth) + smooth / num_classes).reshape(
            F, T, num_classes).transpose(-1, -2))
    return torch.stack(out)


def decision_accuracy(affiliation, dominant):
    """(B,) share of bins whose argmax class is the dominant source, under
    the best of the K! class mappings of each utterance."""
    decision = affiliation.argmax(-2).cpu()  # (B, F, T)
    K = affiliation.shape[-2]
    return torch.stack([
        (decision == torch.tensor(p)[dominant]).double().mean((-2, -1))
        for p in itertools.permutations(range(K))]).max(0).values


def score(observations, images, noise_images, affiliation):
    """((B, S) SI-SDR in dB of the best mask estimate per speaker at the
    reference channel (channel 0), (B,) decision accuracy) of a (B, F, K,
    T) affiliation of the (B, D, N) observations."""
    from ..evaluation import si_sdr_stft
    from ..transform import istft, stft
    Observation = stft(observations)  # (B, D, T, F)
    affiliation = affiliation.to(Observation.device, Observation.real.dtype)
    masked = affiliation.permute(0, 2, 3, 1) * Observation[:, None, 0]
    estimates = istft(masked, num_samples=observations.shape[-1])
    scores = si_sdr_stft(images[:, :, None].cpu().double(),
                         estimates[:, None].cpu().double()).max(-1).values
    return scores, decision_accuracy(affiliation,
                                     dominant_source(images, noise_images))


def integration_quality(observations, images, noise_images, embedding,
                        **fit_kwargs):
    """Fit the vMF integration model on the observations' device from the
    k-means initialization and :func:`score` its masks.

    Args:
        observations: (B, D, N) float time signals.
        images: (B, S, N) reference-channel speech images.
        noise_images: (B, N) reference-channel noise images.
        embedding: (B, F, T, E) embeddings (moved to the device).
        fit_kwargs: passed to ``VMFCACGMMTrainer.fit_predict``.
    Returns:
        ((B, S) SI-SDR in dB of the best estimate per speaker, (B,)
        decision accuracy).
    """
    from ..models.vmfcacgmm import VMFCACGMMTrainer
    from ..transform import stft
    Y = stft(observations).permute(0, 3, 2, 1)  # (B, F, T, D)
    device = observations.device
    affiliation = VMFCACGMMTrainer().fit_predict(
        Y, embedding.to(device),
        initialization=kmeans_initialization(embedding).to(device),
        iterations=_ITERATIONS, **fit_kwargs)  # (B, F, K, T)
    return score(observations, images, noise_images, affiliation)


def passes(scores, accuracy):
    """Do the (B, S) scores and the (B,) accuracies meet the floors?"""
    return (float(accuracy.mean()) >= ACCURACY_FLOOR
            and bool((scores.mean(0) >= MEAN_FLOOR_DB).all())
            and bool((scores >= SINGLE_FLOOR_DB).all()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    observations, images, noise = utterances()
    for kind in EMBEDDINGS:
        scores, accuracy = integration_quality(
            observations.to(args.device), images, noise,
            embeddings(images, noise, kind))
        print(f'{kind}: accuracy {accuracy.numpy().round(3).tolist()}; '
              f'per speaker {scores.numpy().round(2).tolist()}; batch means '
              f'{scores.mean(0).numpy().round(2).tolist()}; worst '
              f'{scores.min().item():.2f} dB; passes '
              f'{passes(scores, accuracy)}')


if __name__ == '__main__':
    main()
