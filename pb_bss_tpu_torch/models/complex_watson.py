"""Complex Watson distribution.

Counterpart of ``pb_bss_tpu.models.complex_watson``: the log-pdf
``kappa |<y, mode>|^2 - log Z(kappa)``, the four log-norm
approximations (low / medium / high concentration and the switched
Tran-Vu form, which the model uses) and the trainer whose M-step takes
the dominant eigenpair of the scatter and inverts the eigenvalue ->
concentration map through a host-built ``hyp1f1`` table (log-spaced,
linearly interpolated with :func:`interp`, the semantics of
``jnp.interp``).

One numeric guard differs from the JAX package: in f32 the medium form's
``log(1 - sum_r e^-k k^r / r!)`` cancels to nothing for 1/D <= k < D - 1
at D >= 6 (-inf at D=8, k=1/8; NaN at k=0.2), so :meth:`ComplexWatson.
log_norm_tran_vu` evaluates that range through the Taylor series of
``1F1(1; D; k)`` (:func:`_log_norm_series`), which is the same function
and converges there. Below 1/D and from D - 1 on it computes what the
JAX package computes.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from ..ops.linalg import eigh
from ._precision import full_fp32
from .base import Model, modelclass

__all__ = ['ComplexWatson', 'ComplexWatsonTrainer', 'normalize_observation',
           'interp', 'is_broadcast_compatible']


def normalize_observation(observation):
    """Unit-norm over the channel axis; (..., N, D) -> (..., N, D)."""
    norm = torch.linalg.vector_norm(observation, dim=-1, keepdim=True)
    return observation / torch.clamp(norm, min=_tiny(observation))


def is_broadcast_compatible(*shapes):
    """True when all shapes can be broadcast against each other."""
    for dim in zip(*[shape[::-1] for shape in shapes]):
        if len(set(dim).union({1})) > 2:
            return False
    return True


def _as_real(scale):
    """A tensor of at least float32 (float64 stays float64)."""
    scale = torch.as_tensor(scale)
    if not scale.is_floating_point() or scale.dtype in (torch.float16,
                                                         torch.bfloat16):
        scale = scale.to(torch.float32)
    return scale


def _log_norm_series(scale, dimension, terms):
    """log Z from the Taylor series of 1F1(1; D; k) [Mardia1999Watson
    Eq. 4] with ``terms`` terms."""
    b_range = torch.arange(dimension, dimension + terms, dtype=scale.dtype,
                           device=scale.device)
    return (math.log(2.) + dimension * math.log(math.pi)
            - math.lgamma(dimension)
            + torch.log1p(torch.cumprod(scale[..., None] / b_range,
                                        -1).sum(-1)))


def _series_terms(dimension):
    """Terms of the series that stands in for the medium form below
    D - 1 (csrc/watson.cuh uses the same count)."""
    return 20 + 2 * dimension


@modelclass
class ComplexWatson(Model):
    mode: torch.Tensor = None  # (..., D)
    concentration: torch.Tensor = None  # (...,)

    def pdf(self, y):
        return torch.exp(self.log_pdf(y))

    def log_pdf(self, y):
        """y: (..., N, D) complex unit vectors (leading dims broadcast
        against the model's) -> (..., N)."""
        with full_fp32():
            result = torch.einsum('...d,...d->...', y,
                                  self.mode[..., None, :].conj())
        result = result.real ** 2 + result.imag ** 2
        result = result * self.concentration[..., None]
        return result - self.log_norm()[..., None]

    @staticmethod
    def log_norm_low_concentration(scale, dimension):
        """Taylor series [Mardia1999Watson Eq. 4], 20 terms — accurate
        below ~20."""
        return _log_norm_series(_as_real(scale), dimension, 20)

    @staticmethod
    def log_norm_medium_concentration(scale, dimension):
        """[Mardia1999Watson Eq. 3] as the JAX package writes it (most of
        the range; see the module docstring for its f32 range)."""
        scale = torch.clamp(_as_real(scale), min=1e-2)  # unstable at zero
        r_range = torch.arange(dimension - 1, dtype=scale.dtype,
                               device=scale.device)
        factorials = torch.tensor(
            [math.factorial(r) for r in range(dimension - 1)],
            dtype=scale.dtype, device=scale.device)
        temp = (scale[..., None] ** r_range * torch.exp(-scale[..., None])
                / factorials)
        return (math.log(2.) + dimension * math.log(math.pi)
                + (1. - dimension) * torch.log(scale) + scale
                + torch.log(1. - temp.sum(-1)))

    @staticmethod
    def log_norm_high_concentration(scale, dimension):
        """Above ~10, D < 8."""
        scale = _as_real(scale)
        return (math.log(2.) + dimension * math.log(math.pi)
                + (1. - dimension) * torch.log(scale) + scale)

    @staticmethod
    def log_norm_tran_vu(scale, dimension):
        """The switched form: the 20-term Taylor series below
        ``1/dimension``, the Mardia Eq. 3 form from ``dimension - 1`` on,
        and between them the series with 20 + 2 D terms
        (where Eq. 3 cancels in f32)."""
        scale = _as_real(scale)
        low = ComplexWatson.log_norm_low_concentration(scale, dimension)
        middle = _log_norm_series(scale, dimension, _series_terms(dimension))
        medium = ComplexWatson.log_norm_medium_concentration(
            scale, dimension)
        return torch.where(scale < 1 / dimension, low,
                           torch.where(scale < dimension - 1, middle,
                                       medium))

    # The exact hyp1f1 norm equals the medium form for integer D; the
    # switched form is the numerically robust equivalent.
    log_norm_1f1 = log_norm_tran_vu

    def log_norm(self):
        return self.log_norm_tran_vu(self.concentration, self.mode.shape[-1])


@functools.lru_cache(maxsize=None)
def _hypergeometric_ratio_grid(dimension, max_concentration, spline_markers):
    """Host table of kappa -> E[|<y, mode>|^2] = M(2, D+1, k) /
    (D M(1, D, k)) for the inverse lookup, as float64 numpy arrays
    (ratio grid, kappa grid). The kappa -> 0 limit (ratio 1/D) is
    prepended, so eigenvalues below the grid map to concentration 0."""
    from scipy.special import hyp1f1
    x = np.logspace(-3, np.log10(max_concentration), spline_markers)
    y = hyp1f1(2, dimension + 1, x) / (dimension * hyp1f1(1, dimension, x))
    x = np.concatenate([[0.0], x])
    y = np.concatenate([[1.0 / dimension], y])
    return y, x


def interp(x, xp, fp):
    """One-dimensional linear interpolation with ``jnp.interp``'s
    semantics: ``fp[0]`` below ``xp[0]``, ``fp[-1]`` above ``xp[-1]``,
    and a zero-width interval takes its left value. ``xp`` ascending."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + delta / torch.where(dx0, 1, dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class ComplexWatsonTrainer:
    def __init__(self, dimension=None, max_concentration=500,
                 spline_markers=1000):
        """
        Args:
            dimension: feature dimension (inferred at ``fit`` if None).
            max_concentration: clip for numerical stability.
            spline_markers: lookup-table resolution.
        """
        self.dimension = dimension
        self.max_concentration = max_concentration
        self.spline_markers = spline_markers

    @property
    def grid(self):
        """(ratio grid, kappa grid), float64 numpy arrays."""
        assert self.dimension is not None, (
            'You need to specify dimension. This can be done at object '
            'instantiation or it can be inferred when using the fit '
            'function.')
        return _hypergeometric_ratio_grid(
            self.dimension, float(self.max_concentration),
            int(self.spline_markers))

    def hypergeometric_ratio(self, concentration):
        from scipy.special import hyp1f1
        return hyp1f1(2, self.dimension + 1, concentration) / (
            self.dimension * hyp1f1(1, self.dimension, concentration))

    def hypergeometric_ratio_inverse(self, eigenvalues):
        """Eigenvalue ratio -> concentration through the log-spaced
        table (monotone, linearly interpolated in float64, clamped to
        [0, max_concentration]); the result has the input's dtype."""
        eigenvalues = torch.as_tensor(eigenvalues)
        dtype = eigenvalues.dtype if eigenvalues.is_floating_point() \
            else torch.float32
        ratio_grid, kappa_grid = self.grid
        device = eigenvalues.device
        return interp(
            eigenvalues.to(torch.float64),
            torch.as_tensor(ratio_grid, device=device),
            torch.as_tensor(kappa_grid, device=device)).to(dtype)

    def fit(self, y, saliency=None) -> ComplexWatson:
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1
        y = normalize_observation(y)
        if saliency is not None:
            saliency = torch.as_tensor(saliency, device=y.device)
            assert is_broadcast_compatible(y.shape[:-1], saliency.shape), (
                y.shape, saliency.shape)
        if self.dimension is None:
            self.dimension = y.shape[-1]
        else:
            assert self.dimension == y.shape[-1], (
                'You initialized the trainer with a different dimension '
                'than you are using to fit a model. Use a new trainer, '
                'when you change the dimension.')
        return self._fit(y, saliency=saliency)

    def _fit(self, y, saliency) -> ComplexWatson:
        """y (..., N, D) unit-norm; saliency broadcastable to (..., N)."""
        with full_fp32():
            if saliency is None:
                covariance = y.transpose(-1, -2) @ y.conj()
                denominator = torch.tensor(
                    y.shape[-2], dtype=_real_dtype(y), device=y.device)
            else:
                weighted = y * saliency[..., None].to(y.dtype)
                covariance = weighted.transpose(-1, -2) @ y.conj()
                denominator = saliency.sum(-1)[..., None, None]
        covariance = covariance / torch.clamp(
            denominator, min=_tiny(y)).to(covariance.dtype)
        eigenvalues, eigenvecs = eigh(covariance)
        mode = eigenvecs[..., -1]
        concentration = self.hypergeometric_ratio_inverse(
            eigenvalues[..., -1])
        return ComplexWatson(mode=mode, concentration=concentration)
