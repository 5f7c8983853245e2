"""Deflation-based affiliation initializer (counterpart of
``pb_bss_tpu.initializer.deflation``): iteratively pick the saliency
peak, estimate a local PSD and its principal mode around it, turn the
similarity to the mode into a posterior and deflate the saliency; the
final class absorbs the remainder.

The time windows around the peaks are ``torch.gather``s with an
``(F, 2n+1)`` index; the principal modes come from
:func:`~pb_bss_tpu_torch.extraction.beamformer.get_pca_vector`, the
batched Jacobi kernel (K1) on a CUDA tensor. ``argmax`` takes the first
of equal maxima, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..extraction.beamformer import (
    get_pca_vector,
    get_power_spectral_density_matrix,
)
from ..permutation_alignment import _vector_norm

__all__ = ['deflationSeed']


def deflationSeed(
        Y,
        sources: int,
        saliencies=None,
        permutation_free: bool = True,
        neighbors: int = 5,
        similarity_transform=None,
        eps=0,
):
    """
    Args:
        Y: (F, T, D) complex STFT observations.
        sources: number of classes K (the last absorbs the rest).
        saliencies: optional (F, T) importance; default ||Y||.
        permutation_free: pick one global peak frame per deflation step
            (instead of a per-frequency peak).
        neighbors: half-width of the local time window.
        similarity_transform: optional callable
            ``(similarity, saliencies) -> similarity``.
        eps: floor of the posterior before its normalization.
    Returns:
        (K, F, T) posterior initialization on Y's device.
    """
    Y = torch.as_tensor(Y)
    if saliencies is None:
        saliencies = torch.linalg.vector_norm(Y, dim=-1)
    saliencies = torch.as_tensor(saliencies, device=Y.device)

    F, T = saliencies.shape
    assert F in [257, 513], F

    Z = _vector_norm(Y, dim=-1)
    offsets = torch.arange(-neighbors, neighbors + 1, device=Y.device)

    posterior = []
    for _ in range(sources - 1):
        if permutation_free:
            maxidx = torch.argmax(saliencies.mean(0), dim=-1)
            maxidx = torch.broadcast_to(maxidx, (F,))
        else:
            maxidx = torch.argmax(saliencies, dim=-1)

        maxidx = torch.clamp(maxidx, neighbors, T - 1 - neighbors)
        window = maxidx[:, None] + offsets[None, :]  # (F, 2n+1)

        # (F, T_local, D) and (F, T_local) gathers around the peaks
        Y_local = torch.gather(
            Y, 1, window[..., None].expand(*window.shape, Y.shape[-1]))
        Y_local = Y_local.transpose(-1, -2)  # (F, D, T_local)
        saliencies_local = torch.gather(saliencies, 1, window)

        psd = get_power_spectral_density_matrix(
            Y_local, mask=saliencies_local)
        mode = get_pca_vector(psd)

        similarity = torch.einsum(
            'ftd,fd->ft', Z.conj(), _vector_norm(mode, dim=-1)).abs() ** 2

        if similarity_transform is not None:
            similarity = similarity_transform(similarity, saliencies)

        posterior.append(similarity)
        saliencies = saliencies * (1 - similarity)

    posterior.append(1 - sum(posterior))
    posterior = torch.stack(posterior)
    posterior = torch.clamp(posterior, min=eps)
    return posterior / torch.sum(posterior, dim=0, keepdim=True)
