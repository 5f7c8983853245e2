"""Independent and identically distributed affiliation initializers
(counterpart of ``pb_bss_tpu.initializer.iid``): uniform normalized,
Dirichlet and random one-hot affiliations, each with
``permutation_free`` (one (K, N) draw shared by every independent
dimension). A ``torch.Generator`` takes the place of the JAX key; the
default is one seeded 0 on Y's device.
"""
from __future__ import annotations

import math

import torch

from .._dtypes import real_dtype as _real_dtype

__all__ = [
    'uniform_normalized',
    'dirichlet_uniform',
    'dirichlet',
    'one_hot',
]


def _generator(generator, device):
    if generator is None:
        return torch.Generator(device).manual_seed(0)
    return generator


def _shape(Y):
    """(independent dims, N) of (..., N, D) observations."""
    return tuple(Y.shape[:-2]), Y.shape[-2]


def uniform_normalized(Y, num_classes: int, permutation_free: bool = False,
                       *, generator=None):
    """Uniform random affiliations normalized over classes.

    Args:
        Y: (..., N, D) observations (only the shape, dtype and device
            are used).
        num_classes: K.
        permutation_free: one (K, N) draw broadcast over all independent
            dims, so that every frequency starts with the same
            permutation.
    Returns:
        (..., K, N) affiliations.

    >>> Y = torch.zeros((5, 100, 3))
    >>> a = uniform_normalized(Y, 2)
    >>> tuple(a.shape), bool(torch.allclose(a.sum(-2), torch.ones(1)))
    ((5, 2, 100), True)
    >>> pf = uniform_normalized(Y, 2, permutation_free=True)
    >>> bool((pf[0] == pf[4]).all())
    True
    """
    Y = torch.as_tensor(Y)
    independent, N = _shape(Y)
    shape = (*independent, num_classes, N)
    g = _generator(generator, Y.device)
    draw = shape[-2:] if permutation_free else shape
    affiliation = torch.rand(draw, generator=g, dtype=_real_dtype(Y),
                             device=Y.device)
    affiliation = affiliation / affiliation.sum(-2, keepdim=True)
    return torch.broadcast_to(affiliation, shape)


def _standard_gamma(alpha, shape, generator, dtype, device):
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's squeeze-free
    rejection (alpha < 1 through ``Gamma(alpha + 1) U^(1 / alpha)``),
    every pending draw redrawn from ``generator`` until accepted."""
    boost = alpha < 1
    a = alpha + 1 if boost else alpha
    d = a - 1 / 3
    c = 1 / math.sqrt(9 * d)
    out = torch.empty(shape, dtype=dtype, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(pending.any()):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        v = (1 + c * x) ** 3
        accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                            + d * torch.log(torch.clamp(v, min=1e-30)))
        take = pending & accept
        out = torch.where(take, d * v, out)
        pending = pending & ~accept
    if boost:
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        out = out * u ** (1 / alpha)
    return out


def dirichlet_uniform(Y, num_classes, permutation_free=False, *,
                      generator=None):
    """Dirichlet(alpha=1) affiliations."""
    return dirichlet(Y, num_classes, permutation_free, alpha=1,
                     generator=generator)


def dirichlet(Y, num_classes: int, permutation_free: bool = False,
              alpha=1, *, generator=None):
    """Dirichlet(alpha)-distributed affiliations over the K classes,
    from normalized Gamma(alpha) draws.

    Returns:
        (..., K, N) affiliations.
    """
    assert isinstance(alpha, (int, float)), alpha
    Y = torch.as_tensor(Y)
    independent, N = _shape(Y)
    shape = (*independent, num_classes, N)
    draw = shape[-2:] if permutation_free else shape
    gamma = _standard_gamma(float(alpha), draw,
                            _generator(generator, Y.device),
                            _real_dtype(Y), Y.device)
    return torch.broadcast_to(gamma / gamma.sum(-2, keepdim=True), shape)


def one_hot(Y, num_classes: int, permutation_free: bool = False, *,
            generator=None):
    """Random hard-assignment affiliations.

    Returns:
        (..., K, N) one-hot affiliations.
    """
    Y = torch.as_tensor(Y)
    independent, N = _shape(Y)
    shape = (*independent, num_classes, N)
    draw = (N,) if permutation_free else (*independent, N)
    labels = torch.randint(0, num_classes, draw,
                           generator=_generator(generator, Y.device),
                           device=Y.device)
    eye = torch.eye(num_classes, dtype=_real_dtype(Y), device=Y.device)
    return torch.broadcast_to(eye[labels].transpose(-1, -2), shape)
