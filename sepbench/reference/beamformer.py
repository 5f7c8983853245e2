"""Mask-based GEV beamforming with blind analytic normalization
(Warsitz and Haeb-Umbach 2007), as the separation pipeline applies it.

For each class the target PSD is the mask-weighted spatial covariance
(the mask normalized over time) and the noise PSD the sum of the other
classes'. The GEV vector is the dominant generalized eigenvector of the
pencil, scaled so that ``w^H phi_nn w = 1``; where the noise PSD is not
positive definite, the pencil is solved again with the noise PSD loaded
by ``1e-5`` of its mean eigenvalue. BAN scales it by
``sqrt(w^H phi_nn^2 w) / |w^H phi_nn w|``. The phases are chained over
the bins (each bin rotated onto its lower neighbour), and the output is
``w^H y``. An eigenvector's phase is arbitrary, so the output of a class
is defined up to one phase over all its bins.
"""
from __future__ import annotations

import torch

from .dhtv import apply_mapping, dhtv_mapping
from .precision import cmm, complex_dtype, eigh, real_dtype

LOADING = 1e-5


def psds(spectrum, mask, precision):
    """spectrum (B, D, T, F), mask (B, K, F, T) -> (B, K, F, D, D)."""
    tiny_sum = 1e-10
    y = spectrum.permute(0, 3, 1, 2).to(complex_dtype(precision))  # BFDT
    mask = mask.to(real_dtype(precision))
    mask = mask / torch.clamp(mask.sum(-1, keepdim=True), min=tiny_sum)
    weighted = mask.transpose(1, 2)[:, :, :, None, :] * y[:, :, None]
    psd = cmm(weighted, y[:, :, None].conj().transpose(-1, -2), precision)
    return psd.transpose(1, 2)  # (B, K, F, D, D)


def _gev(phi_xx, phi_nn):
    """(vectors, bad): ``bad`` marks the pencils whose noise PSD is not
    positive definite; their vectors are solved on the identity in its
    place and are to be replaced."""
    _, info = torch.linalg.cholesky_ex(phi_nn)
    bad = (info != 0)[..., None]
    eye = torch.eye(phi_nn.shape[-1], dtype=phi_nn.dtype,
                    device=phi_nn.device)
    L = torch.linalg.cholesky(torch.where(bad[..., None], eye, phi_nn))
    c = torch.linalg.solve_triangular(L, phi_xx, upper=False)
    c = torch.linalg.solve_triangular(
        L, c.conj().transpose(-1, -2), upper=False).conj().transpose(-1, -2)
    c = (c + c.conj().transpose(-1, -2)) / 2
    _, vectors = eigh(c)
    u = vectors[..., -1:]
    w = torch.linalg.solve_triangular(
        L.conj().transpose(-1, -2), u, upper=True)[..., 0]
    return w, bad


def gev_ban(phi_xx, phi_nn):
    w, bad = _gev(phi_xx, phi_nn)
    if bool(bad.any()):
        D = phi_nn.shape[-1]
        trace = torch.diagonal(phi_nn, dim1=-2, dim2=-1).sum(-1).real
        eye = torch.eye(D, dtype=phi_nn.dtype, device=phi_nn.device)
        loaded = (phi_nn + eye * (LOADING * trace / D)[..., None, None]) \
            / (1 + LOADING)
        w = torch.where(bad, _gev(phi_xx, loaded)[0], w)
    nn_w = (phi_nn @ w[..., None])[..., 0]
    nominator = torch.sqrt((nn_w.conj() * nn_w).sum(-1).real)
    denominator = (w.conj() * nn_w).sum(-1).abs()
    gain = torch.where(denominator == 0, torch.zeros_like(nominator),
                       nominator / torch.where(denominator == 0,
                                               torch.ones_like(denominator),
                                               denominator))
    return w * gain[..., None]


def chain_phases(w):
    """(..., F, D): rotate each bin onto its lower neighbour."""
    inner = (w[..., 1:, :].conj() * w[..., :-1, :]).sum(-1, keepdim=True)
    rotation = torch.cumprod(torch.exp(1j * torch.angle(inner)), dim=-2)
    return torch.cat([w[..., :1, :], w[..., 1:, :] * rotation], dim=-2)


def extract(spectrum, affiliation, precision='float64'):
    """Beamformed spectra (B, K, T, F) from spectra (B, D, T, F) and EM
    affiliations (B, F, K, T): DHTV, then GEV+BAN per class."""
    masks = affiliation.transpose(1, 2).to(real_dtype(precision))
    masks = apply_mapping(masks, dhtv_mapping(masks, precision))
    phi = psds(spectrum, masks, precision)
    phi_nn = phi.sum(1, keepdim=True) - phi
    w = chain_phases(gev_ban(phi, phi_nn))  # (B, K, F, D)
    y = spectrum.permute(0, 3, 1, 2).to(complex_dtype(precision))  # BFDT
    out = cmm(w.conj()[..., None, :], y[:, None], precision)[..., 0, :]
    return out.transpose(-1, -2)  # (B, K, T, F)


__all__ = ['extract', 'psds', 'gev_ban', 'chain_phases']
