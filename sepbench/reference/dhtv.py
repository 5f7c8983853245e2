"""DHTV frequency permutation alignment (Tran Vu and Haeb-Umbach 2015).

Per segment of bins, each bin's classes are reassigned to the segment's
centroid by a greedy assignment of cosine similarities, until no bin of
the utterance changes or the segment's iterations run out. The segment
plan, the greedy rule (the largest score first, the first flat index
among equal ones) and the reverse mapping ``aligned[k, f] =
mask[mapping[k, f], f]`` are those of the system under test at STFT size
512: a main segment of bins 70-170 with 20 iterations, then segments of
100 bins shifted by 20 upwards and downwards in turn, 2 iterations each,
the outermost stretched to the band edges.
"""
from __future__ import annotations

import torch

from .precision import mm, real_dtype


def plan(F, start=70, width=100, shift=20, main=20, sub=2):
    up = [[sub, s, s + width] for s in range(start + shift, F - width, shift)]
    down = [[sub, s, s + width] for s in range(start - shift, 0, -shift)]
    first = [main, start, start + width]
    if up:
        up[-1][-1] = F
    else:
        first[-1] = F
    if down:
        down[-1][1] = 0
    else:
        first[1] = 0
    order = [first]
    for i in range(max(len(up), len(down))):
        order += up[i:i + 1] + down[i:i + 1]
    return order


def _unit(x):
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(norm, min=torch.finfo(x.dtype).tiny)


def _greedy(score):
    """(..., K, K) scores -> (..., K) with ``out[a]`` the class given to
    centroid ``a``."""
    K = score.shape[-1]
    score = score.clone()
    out = torch.zeros(score.shape[:-1], dtype=torch.long,
                      device=score.device)
    for _ in range(K):
        flat = score.flatten(-2).argmax(-1)
        a, k = flat // K, flat % K
        rows = torch.arange(K, device=score.device)
        out = torch.where(rows == a[..., None], k[..., None], out)
        score.masked_fill_((rows == a[..., None])[..., :, None], -torch.inf)
        score.masked_fill_((rows == k[..., None])[..., None, :], -torch.inf)
    return out


def dhtv_mapping(mask, precision='float64', stft_size=512):
    """Reverse mapping (B, K, F) for masks (B, K, F, T)."""
    if stft_size != 512:
        raise ValueError('the reference holds the plan of STFT size 512')
    mask = mask.to(real_dtype(precision))
    B, K, F, T = mask.shape
    features = _unit(mask)
    mapping = torch.arange(K, device=mask.device)[None, :, None] \
        .expand(B, K, F).clone()
    identity = torch.arange(K, device=mask.device)[None, :, None]
    for iterations, start, end in plan(F):
        seg = features[:, :, start:end].clone()  # (B, K, W, T)
        W = end - start
        seg_map = identity.expand(B, K, W).clone()
        active = torch.ones(B, dtype=torch.bool, device=mask.device)
        for _ in range(iterations):
            if not bool(active.any()):
                break
            centroid = _unit(seg.mean(2))  # (B, K, T)
            # score[b, w, a, k] = <seg[b, k, w], centroid[b, a]>
            score = mm(seg.permute(0, 2, 1, 3),
                       centroid.transpose(1, 2)[:, None], precision)
            rev = _greedy(score.transpose(-1, -2)).transpose(1, 2)
            changed = (rev != identity).flatten(1).any(-1)
            moved = torch.gather(seg, 1, rev[..., None].expand_as(seg))
            keep = active[:, None, None]
            seg = torch.where(keep[..., None], moved, seg)
            seg_map = torch.where(keep, torch.gather(seg_map, 1, rev),
                                  seg_map)
            active = active & changed
        features[:, :, start:end] = seg
        mapping[:, :, start:end] = torch.gather(
            mapping[:, :, start:end], 1, seg_map)
    return mapping


def apply_mapping(mask, mapping):
    """``aligned[b, k, f] = mask[b, mapping[b, k, f], f]``."""
    index = mapping[..., None].expand(*mapping.shape, mask.shape[-1])
    return torch.gather(mask, 1, index)


__all__ = ['plan', 'dhtv_mapping', 'apply_mapping']
