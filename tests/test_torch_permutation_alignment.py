"""DHTV permutation alignment of the port against the JAX package on
the same features."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_bss_tpu.permutation_alignment import (
    DHTVPermutationAlignment as JaxDHTV,
    apply_mapping as jax_apply_mapping,
)
from pb_bss_tpu_torch.permutation_alignment import (
    DHTVPermutationAlignment,
    apply_mapping,
)

torch.set_num_threads(2)


def _permuted_masks(K=3, F=257, T=120, seed=0, noise=0.3):
    """Smooth per-class activity patterns shared across bins, permuted
    per bin, plus noise, normalized over classes."""
    rng = np.random.default_rng(seed)
    activity = rng.uniform(size=(K, 1, T)) ** 3
    mask = activity + noise * rng.uniform(size=(K, F, T))
    perms = np.stack([rng.permutation(K) for _ in range(F)], axis=1)
    mask = np.take_along_axis(mask, perms[..., None], axis=0)
    return (mask / mask.sum(0, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize('seed,K', [(0, 3), (1, 2), (2, 4)])
def test_mapping_equals_jax(seed, K):
    mask = _permuted_masks(K=K, seed=seed)
    ref = np.asarray(JaxDHTV.from_stft_size(512).calculate_mapping(
        jnp.asarray(mask)))
    out = DHTVPermutationAlignment.from_stft_size(512).calculate_mapping(
        torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    aligned = apply_mapping(torch.as_tensor(mask), torch.as_tensor(out))
    np.testing.assert_array_equal(
        aligned.numpy(), np.asarray(jax_apply_mapping(mask, ref)))


def test_batch_equals_per_mask():
    """Each batch element keeps its own early exit."""
    masks = np.stack([_permuted_masks(seed=s) for s in (3, 4)])
    masks[1, :, :, :60] = masks[1, :, :, 60:]  # a different trajectory
    pa = DHTVPermutationAlignment.from_stft_size(512)
    batched = pa.calculate_mapping(torch.as_tensor(masks))
    for b in range(2):
        np.testing.assert_array_equal(
            batched[b].numpy(),
            pa.calculate_mapping(torch.as_tensor(masks[b])).numpy())
    np.testing.assert_array_equal(
        pa(torch.as_tensor(masks))[1].numpy(),
        pa(torch.as_tensor(masks[1])).numpy())


def test_alignment_plan():
    assert DHTVPermutationAlignment.from_stft_size(512).alignment_plan \
        == JaxDHTV.from_stft_size(512).alignment_plan
    assert DHTVPermutationAlignment.from_stft_size(1024).alignment_plan \
        == JaxDHTV.from_stft_size(1024).alignment_plan
