"""cACGMM EM (Ito, Araki, Nakatani 2016) with per-bin mixture weights.

The fit the system under test runs by default: the first M-step from
the initial affiliations with unit quadratic forms, ``iterations - 1``
pairs of E-step (affiliations clipped to ``[eps, 1 - eps]``) and
M-step, and a last E-step without clipping, whose affiliations are the
result. The M-step estimates ``D sum_t gamma_t y_t y_t^H / q_t`` over
``sum_t gamma_t`` of unit-norm observations, made Hermitian; its
eigenvalues are divided by the largest and floored. The E-step's
quadratic form is ``sum_e |v_e^H y|^2 / lambda_e``.
"""
from __future__ import annotations

import torch

from .precision import cmm, complex_dtype, eigh, mm, real_dtype


def initialization(seed, batch, frequencies, classes, frames, device,
                   rows=None):
    """The random initial affiliations (batch, F, K, T) that the system
    under test draws for a batch from a master generator seeded
    ``seed``: one 62-bit seed per utterance from the master, then
    uniform draws normalized over the classes. With ``rows``, only those
    utterances' (len(rows), F, K, T)."""
    master = torch.Generator(device).manual_seed(seed)
    seeds = torch.randint(0, 2 ** 62, (batch,), generator=master,
                          device=device).tolist()
    if rows is not None:
        seeds = [seeds[r] for r in rows]
    out = []
    for s in seeds:
        g = torch.Generator(device).manual_seed(s)
        a = torch.rand((frequencies, classes, frames), generator=g,
                       dtype=torch.float32, device=device)
        out.append(a / a.sum(-2, keepdim=True))
    return torch.stack(out)


def _m_step(y, affiliation, quadratic_form, floor, precision):
    D = y.shape[-2]
    tiny = torch.finfo(real_dtype(precision)).tiny
    weight = affiliation.mean(-1, keepdim=True)  # (B, F, K, 1)
    scaled = affiliation / torch.clamp(quadratic_form, min=10 * tiny)
    yw = y[:, :, None] * scaled[:, :, :, None, :]  # (B, F, K, D, T)
    covariance = D * cmm(yw, y[:, :, None].conj().transpose(-1, -2),
                         precision)
    covariance = covariance / torch.clamp(
        affiliation.sum(-1), min=tiny)[..., None, None]
    covariance = (covariance + covariance.conj().transpose(-1, -2)) / 2
    eigenvalues, eigenvectors = eigh(covariance)
    eigenvalues = eigenvalues / torch.clamp(
        eigenvalues.max(-1, keepdim=True).values, min=tiny)
    return weight, torch.clamp(eigenvalues, min=floor), eigenvectors


def _e_step(y, weight, eigenvalues, eigenvectors, eps, precision):
    D = y.shape[-2]
    tiny = torch.finfo(real_dtype(precision)).tiny
    z = cmm(eigenvectors.conj().transpose(-1, -2), y[:, :, None],
            precision)  # (B, F, K, D, T)
    power = z.real ** 2 + z.imag ** 2
    quadratic_form = mm(power.transpose(-1, -2),
                        (1 / eigenvalues)[..., None], precision)[..., 0]
    quadratic_form = torch.clamp(quadratic_form, min=tiny)
    log_pdf = -D * torch.log(quadratic_form) \
        - torch.log(eigenvalues).sum(-1)[..., None]
    affiliation = torch.exp(log_pdf - log_pdf.max(-2, keepdim=True).values)
    affiliation = affiliation * weight
    affiliation = affiliation / torch.clamp(
        affiliation.sum(-2, keepdim=True), min=tiny)
    if eps:
        affiliation = torch.clamp(affiliation, eps, 1 - eps)
    return affiliation, quadratic_form


def unit_observations(spectrum, precision):
    """(B, D, T, F) spectra -> (B, F, D, T) unit-norm observations
    (zero vectors stay zero)."""
    y = spectrum.permute(0, 3, 1, 2).to(complex_dtype(precision))
    norm = torch.sqrt((y.real ** 2 + y.imag ** 2).sum(-2, keepdim=True))
    return y / torch.where(norm == 0, torch.ones_like(norm), norm)


def cacgmm_em(spectrum, initialization, iterations, precision='float64', *,
              eps=1e-10, floor=1e-10, block=None):
    """Affiliations (B, F, K, T) after ``iterations`` EM iterations from
    ``initialization`` (B, F, K, T), for spectra (B, D, T, F). The
    utterances are independent and run ``block`` at a time."""
    B = spectrum.shape[0]
    block = block or B
    out = []
    for start in range(0, B, block):
        y = unit_observations(spectrum[start:start + block], precision)
        affiliation = initialization[start:start + block].to(
            real_dtype(precision))
        quadratic_form = torch.ones_like(affiliation)
        for iteration in range(iterations):
            if iteration:
                affiliation, quadratic_form = _e_step(
                    y, *model, eps, precision)
            model = _m_step(y, affiliation, quadratic_form, floor,
                            precision)
        affiliation, _ = _e_step(y, *model, 0.0, precision)
        out.append(affiliation)
        del y, model
    return torch.cat(out)


__all__ = ['initialization', 'cacgmm_em', 'unit_observations']
