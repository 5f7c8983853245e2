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


# ---- Greedy, Oracle, the optimal mapping and the inline aligner --------

def _random_masks(K=3, F=65, T=50, seed=0):
    """Untied random masks (continuous values), F odd."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(K, F, T)).astype(np.float32)
    return mask / mask.sum(0, keepdims=True)


@pytest.mark.parametrize('algorithm', ['greedy', 'optimal'])
@pytest.mark.parametrize('metric', ['cos', 'multiply', 'euclidean'])
def test_greedy_mapping_equals_jax(metric, algorithm):
    from pb_bss_tpu.permutation_alignment import GreedyPermutationAlignment
    from pb_bss_tpu_torch.permutation_alignment import (
        GreedyPermutationAlignment as TorchGreedy)
    mask = _random_masks(seed=1)
    ref = np.asarray(GreedyPermutationAlignment(metric, algorithm)
                     .calculate_mapping(jnp.asarray(mask)))
    out = TorchGreedy(metric, algorithm).calculate_mapping(
        torch.as_tensor(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize('algorithm', ['greedy', 'optimal'])
@pytest.mark.parametrize('metric', ['cos', 'multiply', 'euclidean'])
def test_oracle_mapping_equals_jax(metric, algorithm):
    from pb_bss_tpu.permutation_alignment import OraclePermutationAlignment
    from pb_bss_tpu_torch.permutation_alignment import (
        OraclePermutationAlignment as TorchOracle)
    mask = _random_masks(K=4, seed=2)
    reference = _random_masks(K=4, seed=3)
    jax_pa = OraclePermutationAlignment(metric, algorithm)
    pa = TorchOracle(metric, algorithm)
    ref = np.asarray(jax_pa.calculate_mapping(jnp.asarray(mask),
                                              jnp.asarray(reference)))
    out = pa.calculate_mapping(torch.as_tensor(mask),
                               torch.as_tensor(reference))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        pa(torch.as_tensor(mask), torch.as_tensor(reference)).numpy(),
        np.asarray(jax_pa(jnp.asarray(mask), jnp.asarray(reference))))


@pytest.mark.parametrize('seed,K', [(0, 3), (2, 4)])
def test_dhtv_optimal_mapping_equals_jax(seed, K):
    params = dict(stft_size=512, segment_start=70, segment_width=100,
                  segment_shift=20, main_iterations=20, sub_iterations=2,
                  algorithm='optimal')
    mask = _permuted_masks(K=K, seed=seed)
    ref = np.asarray(JaxDHTV(**params).calculate_mapping(jnp.asarray(mask)))
    out = DHTVPermutationAlignment(**params).calculate_mapping(
        torch.as_tensor(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_mapping_from_score_matrix_doctest_values():
    """The JAX function's doctest cases, and the port's own doctests."""
    import doctest

    import pb_bss_tpu_torch.permutation_alignment as pa
    score = torch.tensor([[11, 10, 0], [4, 5, 10], [6, 0, 5]])
    assert pa._mapping_from_score_matrix(score, 'optimal').tolist() \
        == [1, 2, 0]
    assert pa._mapping_from_score_matrix(score, 'greedy').tolist() \
        == [0, 2, 1]
    assert pa._mapping_from_score_matrix(
        torch.stack([score, score]), 'greedy').tolist() \
        == [[0, 0], [2, 2], [1, 1]]
    with pytest.raises(ValueError, match='infeasible'):
        pa._mapping_from_score_matrix(
            torch.tensor([[1., float('inf')], [0., 1.]]))
    assert doctest.testmod(pa).failed == 0


def test_optimal_mapping_equals_jax_on_random_scores():
    from pb_bss_tpu.permutation_alignment import (
        _mapping_from_score_matrix as jax_mapping)
    from pb_bss_tpu_torch.permutation_alignment import (
        _mapping_from_score_matrix)
    scores = np.random.default_rng(7).standard_normal((40, 4, 4)).astype(
        np.float32)
    for algorithm in ('greedy', 'optimal'):
        np.testing.assert_array_equal(
            _mapping_from_score_matrix(torch.as_tensor(scores),
                                       algorithm).numpy(),
            np.asarray(jax_mapping(jnp.asarray(scores), algorithm)))


def test_sample_random_mapping_is_a_permutation_per_bin():
    from pb_bss_tpu_torch.permutation_alignment import sample_random_mapping
    mapping = sample_random_mapping(4, 9, torch.Generator().manual_seed(3))
    assert mapping.shape == (4, 9)
    assert torch.equal(mapping.sort(0).values,
                       torch.arange(4)[:, None].expand(4, 9))
    assert torch.equal(sample_random_mapping(4, 9),
                       sample_random_mapping(4, 9))


def _two_source_stft(seed=0, F=257, T=60, D=3):
    """The JAX inline-PA suite's scenario (tests/test_models/
    test_inline_pa.py): two sources alternating frame by frame."""
    rng = np.random.RandomState(seed)
    atf = rng.randn(F, D, 2) + 1j * rng.randn(F, D, 2)
    active = np.arange(T) % 2 == 0
    y = np.where(active[None, :, None], atf[:, None, :, 0],
                 atf[:, None, :, 1])
    y = y * np.exp(2j * np.pi * rng.rand(F, T, 1))
    y = y + 0.05 * (rng.randn(F, T, D) + 1j * rng.randn(F, T, D))
    return y.astype(np.complex64)


@pytest.mark.parametrize('use_fused_em', [False, True], ids=['scan', 'fc'])
@pytest.mark.parametrize('aligner', ['greedy', 'dhtv'])
def test_cacgmm_inline_pa(aligner, use_fused_em):
    """With the inline aligner (on the scan path, or between the
    frequency-constant route's steps) the class identities agree across
    frequency: the JAX suite's bar, > 0.85."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.permutation_alignment import (
        GreedyPermutationAlignment)
    aligner = (GreedyPermutationAlignment('cos') if aligner == 'greedy'
               else DHTVPermutationAlignment.from_stft_size(512))
    y = torch.as_tensor(_two_source_stft())
    model = CACGMMTrainer().fit(
        y, num_classes=2, iterations=10, weight_constant_axis=(-3, -1),
        inline_permutation_aligner=aligner, use_fused_em=use_fused_em)
    affiliation = model.predict(y).numpy()
    assert affiliation.shape == (257, 2, 60)
    np.testing.assert_allclose(affiliation.sum(-2), 1.0, rtol=1e-4)
    decision = affiliation.argmax(-2)  # (F, T)
    majority = (decision.mean(0) > 0.5).astype(int)
    agreement = (decision == majority[None, :]).mean(-1)
    agreement = np.maximum(agreement, 1 - agreement)
    assert agreement.mean() > 0.85, agreement.mean()


@pytest.mark.parametrize('with_qf', [False, True])
def test_apply_inline_permutation_alignment_equals_jax(with_qf):
    from pb_bss_tpu.models.mixture_model_utils import (
        apply_inline_permutation_alignment as jax_apply)
    from pb_bss_tpu.permutation_alignment import GreedyPermutationAlignment
    from pb_bss_tpu_torch.models.mixture_model_utils import (
        apply_inline_permutation_alignment)
    from pb_bss_tpu_torch.permutation_alignment import (
        GreedyPermutationAlignment as TorchGreedy)
    aff = _random_masks(K=3, F=33, T=40, seed=8).transpose(1, 0, 2)
    qf = np.random.default_rng(9).uniform(0.5, 2., aff.shape).astype(
        np.float32)
    kwargs = dict(weight_constant_axis=(-3, -1))
    ref = jax_apply(jnp.asarray(aff),
                    quadratic_form=jnp.asarray(qf) if with_qf else None,
                    aligner=GreedyPermutationAlignment('cos'), **kwargs)
    out = apply_inline_permutation_alignment(
        torch.as_tensor(aff),
        quadratic_form=torch.as_tensor(qf) if with_qf else None,
        aligner=TorchGreedy('cos'), **kwargs)
    ref, out = (ref, out) if with_qf else ((ref,), (out,))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_fc_greedy_scan_fit_matches_jax():
    """A 3-iteration frequency-constant fit with the inline Greedy
    aligner on the port's scan path against the JAX scan path, at the
    tolerance JAX holds between its own routes (2e-3)."""
    import jax
    from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
    from pb_bss_tpu.permutation_alignment import GreedyPermutationAlignment
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.permutation_alignment import (
        GreedyPermutationAlignment as TorchGreedy)
    y = _two_source_stft(seed=3, F=33, T=40, D=4)
    init = jax.random.uniform(jax.random.key(0), (33, 3, 40), jnp.float32)
    init = np.array(init / init.sum(1, keepdims=True))
    kwargs = dict(iterations=3, weight_constant_axis=(-3, -1),
                  use_fused_em=False)
    ref = JaxTrainer().fit(
        jnp.asarray(y), initialization=jnp.asarray(init),
        inline_permutation_aligner=GreedyPermutationAlignment(), **kwargs)
    out = CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=torch.as_tensor(init),
        inline_permutation_aligner=TorchGreedy(), **kwargs)
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(ref.weight),
                               atol=2e-3)
    np.testing.assert_allclose(out.cacg.covariance_eigenvalues.numpy(),
                               np.asarray(ref.cacg.covariance_eigenvalues),
                               atol=2e-3)
