"""Frequency permutation alignment (DHTV).

Counterpart of ``pb_bss_tpu.permutation_alignment`` for the separation
slice: ``DHTVPermutationAlignment`` (multi-resolution alignment
[TranVu2015BSS]: per segment, all bins are realigned at once against
the segment centroid by a greedy assignment, with the nothing-changed
early exit) and ``apply_mapping``. Permutations are applied with
integer indexing (``torch.gather``).

Leading batch dimensions are allowed: ``mask`` (*B, K, F, T) gives a
mapping (*B, K, F). Each batch element keeps its own early exit (an
element whose mapping stopped changing keeps its state while the others
iterate), exactly what ``vmap`` of the JAX package's while loop does.
"""
from __future__ import annotations

import torch

from .models._precision import full_fp32

__all__ = ['DHTVPermutationAlignment', 'apply_mapping']


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


def _greedy_mapping(score):
    """Greedy assignment on (..., K, K) scores: K times take the global
    argmax (i, j) (first flat index among ties), record
    ``mapping[i] = j`` and eliminate row i and column j. Returns the
    (..., K) reverse mapping."""
    K = score.shape[-1]
    score = score.clone()
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


class DHTVPermutationAlignment:
    """Multi-resolution frequency permutation alignment
    [TranVu2015BSS]. Does not solve the global permutation problem."""

    def __init__(self, *, stft_size, segment_start, segment_width,
                 segment_shift, main_iterations, sub_iterations,
                 similarity_metric='cos', algorithm='greedy'):
        if algorithm != 'greedy':
            raise NotImplementedError(
                f'algorithm={algorithm!r}: only the greedy mapping is '
                'ported yet (ROADMAP queue 1, permutation alignment)')
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
            rev = _greedy_mapping(score.real).transpose(1, 2)  # (B, K, W)
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

    @staticmethod
    def apply_mapping(mask, mapping):
        return apply_mapping(mask, mapping)

    def __call__(self, mask):
        """Calculate the mapping and apply it to ``mask`` (*B, K, F, T)."""
        return self.apply_mapping(mask, self.calculate_mapping(mask))
