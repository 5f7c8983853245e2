"""Spatial+spectral integration-model example on the PyTorch port
(``pb_bss_tpu_torch``; the counterpart of integration_model_example.py)
[Drude2019 Integration].

The integration models couple the per-frequency spatial cACG mixture
with a GLOBAL spectral model on a Deep-Clustering-style embedding:
``VMFCACGMM`` (von Mises-Fisher spectral model) and ``GCACGMM``
(Gaussian spectral model). The spectral model ties the per-frequency
mixtures together, so no permutation alignment pass is needed — the
embedding resolves the frequency permutation.

This example builds a synthetic 2-speaker mixture plus a surrogate
embedding (an oracle-leaky one-hot per T-F bin, standing in for a DC
network's output), fits both integration models, and compares their
masks to the oracle. On the card the fit takes the integration
statistics kernel once per iteration after the first and the Jacobi
kernel in every M-step; ``--device cpu`` runs their plain twins.

Run: python examples/integration_model_example_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch


def make_scene(seed=0, F=129, T=200, D=6, K=2):
    """Per-frequency directional mixture with TF-sparse sources."""
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, K)) + 1j * rng.standard_normal(
        (F, D, K))
    # TF-sparse speech-like sources: log-normal envelopes
    env = np.exp(1.5 * rng.standard_normal((F, K, T)))
    s = env * (rng.standard_normal((F, K, T))
               + 1j * rng.standard_normal((F, K, T)))
    y = np.einsum('fdk,fkt->fdt', atf, s) + 0.1 * (
        rng.standard_normal((F, D, T))
        + 1j * rng.standard_normal((F, D, T)))
    dominant = np.argmax(np.abs(s), axis=1)  # (F, T)
    return np.swapaxes(y, -1, -2).astype(np.complex64), dominant


def make_embedding(dominant, K, E=20, leak=0.3, seed=1):
    """Surrogate DC embedding: class prototypes + leak + noise."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((K, E))
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    emb = protos[dominant]  # (F, T, E)
    emb = (1 - leak) * emb + leak * rng.standard_normal(emb.shape)
    return (emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            ).astype(np.float32)


def main(device='cuda'):
    device = torch.device(device)
    F, T, D, K = 129, 200, 6, 2
    observation, dominant = make_scene(F=F, T=T, D=D, K=K)
    embedding = make_embedding(dominant, K)

    from pb_bss_tpu_torch.models import GCACGMMTrainer, VMFCACGMMTrainer

    obs = torch.as_tensor(observation, device=device)
    emb = torch.as_tensor(embedding, device=device)

    def fit_predict(trainer_cls, **kw):
        affiliation = trainer_cls().fit_predict(
            obs, emb, num_classes=K, iterations=40,
            generator=torch.Generator(device).manual_seed(0), **kw)
        return affiliation.cpu().numpy()                      # (F, K, T)

    for name, aff in [
        ('VMFCACGMM', fit_predict(VMFCACGMMTrainer)),
        ('GCACGMM (spherical)', fit_predict(GCACGMMTrainer)),
    ]:
        # best class permutation against the oracle dominance mask
        accs = []
        for perm in ([0, 1], [1, 0]):
            acc = np.mean(
                (aff[:, perm].argmax(1) == dominant).astype(float))
            accs.append(acc)
        print(f'{name}: dominant-bin accuracy {max(accs):.3f} '
              f'(chance 0.5)')


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    main(device=parser.parse_args().device)
