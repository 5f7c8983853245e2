"""Frequency permutation alignment.

Counterpart of ``pb_bss_tpu.permutation_alignment``:

* ``DHTVPermutationAlignment`` (multi-resolution alignment
  [TranVu2015BSS]: per segment, all bins are realigned at once against
  the segment centroid by a greedy or optimal assignment, with the
  nothing-changed early exit). Leading batch dimensions are allowed:
  ``mask`` (*B, K, F, T) gives a mapping (*B, K, F), and each batch
  element keeps its own early exit, exactly what ``vmap`` of the JAX
  package's while loop does.
* ``GreedyPermutationAlignment``: a chain over adjacent bins. The
  composition of the adjacent-bin mappings is a prefix composition of
  permutations over F, which is associative: it runs in ceil(log2 F)
  doubling steps of ``torch.gather`` (the JAX package runs it as
  ``lax.associative_scan``), not F - 1 sequential gathers.
* ``OraclePermutationAlignment``: alignment against a reference mask.
* ``apply_mapping``, ``sample_random_mapping`` and the score matrices
  and assignments behind them.

Permutations are applied with integer indexing (``torch.gather``), not
the JAX package's one-hot contractions.
"""
from __future__ import annotations

import itertools

import torch

from .models._precision import full_fp32

__all__ = [
    'DHTVPermutationAlignment',
    'OraclePermutationAlignment',
    'GreedyPermutationAlignment',
    'apply_mapping',
    'sample_random_mapping',
]


def interleave(*lists):
    """Interleave lists of possibly different lengths."""
    iterators = [iter(x) for x in lists]
    while True:
        for idx in range(len(iterators)):
            try:
                if iterators[idx] is not None:
                    yield next(iterators[idx])
            except StopIteration:
                iterators[idx] = None
        if all(i is None for i in iterators):
            break


def sample_random_mapping(K, F, generator=None):
    """Random (K, F) mapping, one permutation per frequency."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.stack(
        [torch.randperm(K, generator=generator) for _ in range(F)], dim=1)


def apply_mapping(mask, mapping):
    """Apply a reverse mapping: ``aligned[..., k, f] =
    mask[..., mapping[..., k, f], f]``.

    Args:
        mask: (*B, K, F, ...) permuted mask.
        mapping: (*B, K, F) integer reverse mapping.
    """
    assert mask.shape[:mapping.ndim] == mapping.shape, (
        mask.shape, mapping.shape)
    index = mapping.reshape(
        mapping.shape + (1,) * (mask.ndim - mapping.ndim))
    return torch.gather(mask, mapping.ndim - 2, index.expand(mask.shape))


def _vector_norm(a, dim=-1):
    """Unit norm; zero vectors stay zero."""
    norm = torch.sqrt((a * a.conj()).real.sum(dim, keepdim=True))
    return a / torch.clamp(norm, min=torch.finfo(norm.dtype).tiny)


class _ScoreMatrix:
    """Score matrices: ``mask`` / ``reference_mask`` (K, ..., T) give
    (..., K, K) with ``score[..., a, b]`` the similarity of ``mask[b]``
    to ``reference_mask[a]``."""

    @classmethod
    def cos(cls, mask, reference_mask):
        return cls.multiply(_vector_norm(mask), _vector_norm(reference_mask))

    @classmethod
    def multiply(cls, mask, reference_mask):
        with full_fp32():
            return torch.einsum('K...T,k...T->...kK', mask.conj(),
                                reference_mask)

    @classmethod
    def euclidean(cls, mask, reference_mask):
        # score[..., a, b] = -||mask[b] - reference_mask[a]||
        diff = mask[None] - reference_mask[:, None]
        dist = torch.sqrt((diff * diff.conj()).real.sum(-1))  # (a, b, ...)
        return -torch.movedim(dist, (0, 1), (-2, -1))

    @classmethod
    def from_name(cls, similarity_metric):
        try:
            return getattr(cls, similarity_metric)
        except AttributeError as e:
            attrs = ', '.join(a for a in dir(cls)
                              if not a.startswith('__') and a != 'from_name')
            raise AttributeError(
                str(e) + '\nSuggestions: ' + attrs) from e


def _greedy_mapping(score):
    """Greedy assignment on (..., K, K) scores: K times take the global
    argmax (i, j) (first flat index among ties), record
    ``mapping[i] = j`` and eliminate row i and column j. Returns the
    (..., K) reverse mapping."""
    K = score.shape[-1]
    score = score.to(torch.promote_types(score.dtype, torch.float32),
                     copy=True)
    iota = torch.arange(K, device=score.device)
    mapping = torch.zeros(score.shape[:-1], dtype=torch.long,
                          device=score.device)
    for _ in range(K):
        idx = score.flatten(-2).argmax(-1)
        i = torch.div(idx, K, rounding_mode='floor')
        j = idx % K
        row_hit = iota == i[..., None]
        col_hit = iota == j[..., None]
        score.masked_fill_(row_hit[..., :, None], -torch.inf)
        score.masked_fill_(col_hit[..., None, :], -torch.inf)
        mapping = torch.where(row_hit, j[..., None], mapping)
    return mapping


def _permutation_table(K):
    return torch.tensor(list(itertools.permutations(range(K))))  # (K!, K)


def _optimal_mapping(score):
    """Optimal assignment over the K! permutations (first best
    permutation among ties): one gather, a sum and an argmax."""
    K = score.shape[-1]
    assert K <= 8, (K, 'K! search space too large; use greedy')
    perms = _permutation_table(K).to(score.device)  # (P, K)
    rows = torch.arange(K, device=score.device)[None, :]
    totals = score[..., rows, perms].sum(-1)  # (..., P)
    return perms[totals.argmax(-1)]  # (..., K)


def _mapping_from_score_matrix(score_matrix, algorithm='optimal', *,
                               check_finite=True):
    """Reverse mapping (K, ...) from a (..., K, K) score matrix.

    ``check_finite`` raises on a non-finite score matrix (a host
    synchronization on the card); the aligners skip it, as the JAX
    package skips it inside ``jit``.

    >>> score_matrix = [[11, 10, 0], [4, 5, 10], [6, 0, 5]]
    >>> _mapping_from_score_matrix(torch.tensor(score_matrix)).tolist()
    [1, 2, 0]
    >>> _mapping_from_score_matrix(torch.tensor(score_matrix), 'greedy'
    ...                            ).tolist()
    [0, 2, 1]
    >>> _mapping_from_score_matrix(
    ...     torch.tensor([score_matrix, score_matrix]), 'greedy').tolist()
    [[0, 0], [2, 2], [1, 1]]
    """
    score_matrix = torch.as_tensor(score_matrix)
    if check_finite and not bool(torch.isfinite(score_matrix).all()):
        raise ValueError('score matrix is infeasible')
    if algorithm == 'greedy':
        mapping = _greedy_mapping(score_matrix)
    elif algorithm == 'optimal':
        mapping = _optimal_mapping(score_matrix)
    else:
        raise ValueError(algorithm)
    return torch.movedim(mapping, -1, 0)


class _PermutationAlignment:
    def calculate_mapping(self, mask, *args, **kwargs):
        raise NotImplementedError()

    def __call__(self, mask, *args, **kwargs):
        """Calculate the mapping and apply it to ``mask`` (K, F, T)."""
        return self.apply_mapping(
            mask, self.calculate_mapping(mask, *args, **kwargs))

    @staticmethod
    def apply_mapping(mask, mapping):
        return apply_mapping(mask, mapping)


class DHTVPermutationAlignment(_PermutationAlignment):
    """Multi-resolution frequency permutation alignment
    [TranVu2015BSS]. Does not solve the global permutation problem."""

    def __init__(self, *, stft_size, segment_start, segment_width,
                 segment_shift, main_iterations, sub_iterations,
                 similarity_metric='cos', algorithm='greedy'):
        if algorithm not in ('greedy', 'optimal'):
            raise ValueError(algorithm)
        self.stft_size = stft_size
        self.segment_start = segment_start
        self.segment_width = segment_width
        self.segment_shift = segment_shift
        self.main_iterations = main_iterations
        self.sub_iterations = sub_iterations
        self.similarity_metric = similarity_metric
        self.algorithm = algorithm

    @classmethod
    def from_stft_size(cls, stft_size, similarity_metric='cos'):
        """Default parameterization for stft_size 512/1024."""
        if stft_size == 512:
            segment_start = 70
        elif stft_size == 1024:
            segment_start = 100
        else:
            raise ValueError(
                f'There is no default for stft_size={stft_size}.')
        return cls(stft_size=stft_size, segment_start=segment_start,
                   segment_width=100, segment_shift=20,
                   main_iterations=20, sub_iterations=2,
                   similarity_metric=similarity_metric)

    @property
    def alignment_plan(self):
        """Static [(iterations, start, end)] segment plan.

        >>> DHTVPermutationAlignment.from_stft_size(512).alignment_plan
        [[20, 70, 170], [2, 90, 190], [2, 50, 150], [2, 110, 210], \
[2, 30, 130], [2, 130, 230], [2, 0, 110], [2, 150, 257]]
        """
        F = self.stft_size // 2 + 1
        if self.segment_start + self.segment_width > F:
            raise ValueError(
                f'segment_start ({self.segment_start}) + segment_width '
                f'({self.segment_width}) must be smaller than '
                f'stft_size // 2 + 1 ({F})')
        plan_lower = [
            [self.sub_iterations, s, s + self.segment_width]
            for s in range(self.segment_start + self.segment_shift,
                           F - self.segment_width, self.segment_shift)]
        plan_higher = [
            [self.sub_iterations, s, s + self.segment_width]
            for s in range(self.segment_start - self.segment_shift, 0,
                           -self.segment_shift)]
        first = [self.main_iterations, self.segment_start,
                 self.segment_start + self.segment_width]
        if plan_lower:
            plan_lower[-1][-1] = F
        else:
            first[-1] = F
        if plan_higher:
            plan_higher[-1][1] = 0
        else:
            first[1] = 0
        return [first] + list(interleave(plan_lower, plan_higher))

    def _align_block(self, features, iterations):
        """Iteratively align all bins of one segment against its
        centroid.

        Args:
            features: (B, K, W, T).
        Returns:
            (features, mapping (B, K, W)): the realigned features and
            the composed reverse permutation of this block.
        """
        B, K, W, T = features.shape
        identity = torch.arange(K, device=features.device)[:, None] \
            .expand(K, W)
        mapping = identity.expand(B, K, W).clone()
        active = torch.ones(B, dtype=torch.bool, device=features.device)
        for _ in range(iterations):
            if not bool(active.any()):  # nothing changed anywhere
                break
            centroid = features.mean(dim=2)  # (B, K, T)
            if self.similarity_metric == 'cos':
                centroid = _vector_norm(centroid)
            # score[b, w, a, k] = <features[b, k, w], centroid[b, a]>
            with full_fp32():
                score = torch.einsum(
                    'bkwt,bat->bwak', features.conj(), centroid)
            assign = (_greedy_mapping if self.algorithm == 'greedy'
                      else _optimal_mapping)
            rev = assign(score.real).transpose(1, 2)  # (B, K, W)
            changed = (rev != identity).flatten(1).any(-1)
            new_features = torch.gather(
                features, 1, rev[..., None].expand(B, K, W, T))
            new_mapping = torch.gather(mapping, 1, rev)
            keep = active[:, None, None]
            features = torch.where(keep[..., None], new_features, features)
            mapping = torch.where(keep, new_mapping, mapping)
            active = active & changed
        return features, mapping

    def calculate_mapping(self, mask):
        """Reverse mapping (*B, K, F) for a permuted mask (*B, K, F, T)."""
        *batch, K, F, T = mask.shape
        assert F % 2 == 1, (F, 'Sure? Usually F is odd.')
        mask = mask.reshape(-1, K, F, T)
        if self.similarity_metric == 'cos':
            features = _vector_norm(mask)
        else:
            features = mask.clone()
        mapping = torch.arange(K, device=mask.device)[:, None] \
            .expand(mask.shape[0], K, F).clone()
        for iterations, start, end in self.alignment_plan:
            segment, block_mapping = self._align_block(
                features[..., start:end, :], iterations)
            features[..., start:end, :] = segment
            mapping[..., start:end] = torch.gather(
                mapping[..., start:end], 1, block_mapping)
        return mapping.reshape(*batch, K, F)


class GreedyPermutationAlignment(_PermutationAlignment):
    """Chain alignment over adjacent frequencies: each bin is assigned
    greedily to its lower neighbour, and the adjacent-bin mappings are
    composed along F."""

    def __init__(self, similarity_metric='euclidean', algorithm='optimal'):
        self.similarity_metric = similarity_metric
        _ScoreMatrix.from_name(similarity_metric)  # validate
        self.algorithm = algorithm

    def calculate_mapping(self, mask):
        """mask: (K, F, T) -> mapping (K, F)."""
        K, F, T = mask.shape
        assert K < 10, (K, 'Sure?')
        assert F % 2 == 1, (F, 'Sure? Usually F is odd.', mask.shape)
        get_score = _ScoreMatrix.from_name(self.similarity_metric)
        scores = get_score(mask[:, 1:, :], mask[:, :-1, :])  # (F-1, K, K)
        pairwise = _mapping_from_score_matrix(
            scores, algorithm='greedy', check_finite=False)  # (K, F-1)
        prefix = torch.cat(
            [torch.arange(K, device=mask.device)[:, None], pairwise],
            dim=-1).T.contiguous()  # (F, K)
        # final[f] = m_f[final[f - 1]]: compose(a, b)[k] = b[a[k]] is
        # associative, so an inclusive prefix scan by doubling
        step = 1
        while step < F:
            composed = torch.gather(prefix[step:], 1, prefix[:-step])
            prefix = torch.cat([prefix[:step], composed])
            step *= 2
        return prefix.T


class OraclePermutationAlignment(_PermutationAlignment):
    """Align against a reference mask (global speaker
    identification)."""

    def __init__(self, similarity_metric='euclidean', algorithm='optimal'):
        assert algorithm in ['greedy', 'optimal'], algorithm
        self.similarity_metric = similarity_metric
        _ScoreMatrix.from_name(similarity_metric)  # validate
        self.algorithm = algorithm

    def calculate_mapping(self, mask, reference_mask):
        """mask / reference_mask: (K, *F, T) -> mapping (K, *F)."""
        assert mask.shape == reference_mask.shape, (
            mask.shape, reference_mask.shape)
        K, *F, T = mask.shape
        assert K < 10, (K, 'Sure?')
        if len(F) == 1:
            assert F[0] % 2 == 1, (F, 'Sure? Usually F is odd.', mask.shape)
        get_score = _ScoreMatrix.from_name(self.similarity_metric)
        return _mapping_from_score_matrix(
            get_score(mask, reference_mask), self.algorithm,
            check_finite=False)
