"""Jointly-diagonalizable full-rank spatial covariance analysis (FCA).

Counterpart of ``pb_bss_tpu.models.fca``. Per frequency ``f``::

    y_ft ~ CN(0,  sum_j  v_jft  R_jf),      R_jf = Q_f^{-1} diag(lambda_jf) Q_f^{-H}

all K source spatial covariances share one diagonalizer ``Q_f``; in the
transformed domain ``z_ft = Q_f y_ft`` every channel is an independent
zero-mean complex Gaussian of variance ``sigma2_fdt = sum_j v_jft
lambda_jfd``. The fit alternates Itakura-Saito multiplicative updates
of ``v`` and ``lambda`` with iterative-projection (IP) updates of the
rows of ``Q``, each row a :func:`~pb_bss_tpu_torch.ops.linalg.
stable_solve` over every bin (on CUDA one launch of the batched Jacobi
kernel K1 for its pseudo-inverse fallback, computed for every bin and
selected branchlessly). The variances are fixed through a sweep, so the
D rows' weighted covariances come from one batched real GEMM over the
Hermitian frame products ``y y^H``, which are built once a fit.

Every bin is independent, so a batch of utterances folds into the bin
axis: (B, F, T, D) observations as (B F, T, D).

Layout: time-last internally ((F, D, T) observations, (F, K, T) masks);
the public API takes (F, T, D) observations.
"""
from __future__ import annotations

import warnings

import torch

from .._dtypes import real_dtype as _real_dtype
from ..ops.linalg import stable_solve
from ..utils import profiling
from ._precision import full_fp32
from .base import Model, modelclass

__all__ = ['FCA', 'FCATrainer']

_EPS = 1e-10


def _sigma2(power, eigenvalue):
    """(F, K, T), (F, K, D) -> per-channel variances (F, D, T)."""
    with full_fp32():
        return torch.einsum('fkt,fkd->fdt', power, eigenvalue) + _EPS


def _transformed_power(diagonalizer, y):
    """|Q y|^2 and Q y: (F, D, D), (F, D, T) -> (F, D, T) real, complex."""
    with full_fp32():
        z = diagonalizer @ y
    return z.real ** 2 + z.imag ** 2, z


@modelclass
class FCA(Model):
    """Fitted jointly-diagonalizable full-rank model.

    Fields:
        diagonalizer: (F, D, D) complex — rows are the demixing-like
            filters ``Q_f`` (shared by all sources).
        eigenvalue: (F, K, D) positive — per-source spatial spectra in
            the diagonalized domain (normalized to mean_d == 1).
        power: (F, K, T) positive — per-source time-varying powers of
            the utterance the model was fitted on.
    """
    diagonalizer: torch.Tensor = None
    eigenvalue: torch.Tensor = None
    power: torch.Tensor = None

    def _gains(self):
        """Per-source Wiener gains in the diagonalized domain, (F, K, D,
        T) in [0, 1], summing to one over K (a per-class epsilon of
        ``_EPS / K``)."""
        K = self.power.shape[-2]
        with full_fp32():
            numerator = torch.einsum(
                'fkt,fkd->fkdt', self.power, self.eigenvalue) + _EPS / K
        return numerator / numerator.sum(-3, keepdim=True)

    def predict(self, y=None):
        """Soft masks (F, K, T): channel-averaged Wiener gains (``y`` is
        unused, for the mixture models' signature)."""
        return self._gains().mean(-2)

    @profiling.span('fca.separate')
    def separate(self, y):
        """Wiener source images.

        Args:
            y: (F, T, D) complex — the mixture the model was fitted on.
        Returns:
            (F, K, T, D) complex source images summing to ``y`` over K.
        The back-transform inverts ``Q`` through :func:`stable_solve`,
        so that a near-singular ``Q`` in some bins takes the
        pseudo-inverse instead of emitting inf or NaN.
        """
        assert y.is_complex(), y.dtype
        _, z = _transformed_power(self.diagonalizer, y.transpose(-2, -1))
        z_k = self._gains() * z[:, None]  # (F, K, D, T)
        eye = torch.eye(self.diagonalizer.shape[-1],
                        dtype=self.diagonalizer.dtype,
                        device=self.diagonalizer.device)
        q_inv = stable_solve(self.diagonalizer,
                             eye.expand(self.diagonalizer.shape))
        with full_fp32():
            images = torch.einsum('fde,fket->fkdt', q_inv, z_k)
        return images.transpose(-2, -1)

    def log_likelihood(self, y):
        """Average log-likelihood per (f, t) frame, up to the
        ``-D log pi`` constant."""
        y_int = y.transpose(-2, -1)
        p, _ = _transformed_power(self.diagonalizer, y_int)
        sigma2 = _sigma2(self.power, self.eigenvalue)
        F, _, T = y_int.shape
        _, logabsdet = torch.linalg.slogdet(self.diagonalizer)
        ll = 2.0 * logabsdet.sum() * T - torch.sum(
            torch.log(sigma2) + p / sigma2)
        return ll / (F * T)


class _FrameProducts:
    """The fit's Hermitian frame products, built once a fit: ``y_a
    conj(y_b)`` for ``a <= b`` of each (bin, frame), the D (D + 1) / 2
    complex entries of the upper triangle row by row, stored as
    (real, imaginary) pairs: ``values`` (F, T, D (D + 1)) real.

    They weigh D (D + 1) / 2 complex entries a (bin, frame), 3.5 times
    y at D = 6, and grow quadratically in D.
    """

    def __init__(self, y):
        """``y``: (F, D, T) complex observations."""
        F, D, T = y.shape
        frames = y.transpose(-2, -1)  # (F, T, D)
        products = torch.empty((F, T, D * (D + 1) // 2), dtype=y.dtype,
                               device=y.device)
        start = 0
        # a multiply a row a, written into the buffer: the build holds
        # no transient of the products' size
        for a in range(D):
            stop = start + D - a
            torch.mul(frames[..., a, None], frames[..., a:].conj(),
                      out=products[..., start:stop])
            start = stop
        self.values = torch.view_as_real(products).flatten(-2)
        # (a, b) -> the packed entry of (min, max), conjugated below
        # the diagonal; made on the device, so nothing waits for it
        row = torch.arange(D, device=y.device)
        low, high = (torch.minimum(row[:, None], row),
                     torch.maximum(row[:, None], row))
        self.index = low * (2 * D + 1 - low) // 2 + high - low  # (D, D)
        below = (row[:, None] > row).to(self.values.dtype)
        self.sign = torch.stack([torch.ones_like(below), 1 - 2 * below],
                                -1)  # (D, D, 2)

    def covariances(self, sigma2):
        """Every row's ``V_d = mean_t y y^H / sigma2_d`` of an IP sweep
        in one batched GEMM over the frame products: (F, D, T) variances
        -> (F, D, D, D) complex, ``[:, d]`` the Hermitian ``V_d``."""
        F, D, T = sigma2.shape
        with full_fp32():
            sums = torch.bmm((T * sigma2).reciprocal(), self.values)
        pairs = sums.view(F, D, -1, 2)[:, :, self.index] * self.sign
        return torch.view_as_complex(pairs)


def _ip_update(q, products, sigma2):
    """One iterative-projection sweep over the diagonalizer's rows: for
    row d, ``h = (Q V_d)^{-1} e_d`` with ``V_d = mean_t y y^H /
    sigma2_d``, scaled to ``h^H V_d h == 1``; the row becomes ``h^H``.
    The sweep's D covariances come from ``products``
    (:class:`_FrameProducts`) at once, before the first row."""
    F, D, _ = sigma2.shape
    profiling.count('fca.ip_sweeps')
    covariances = products.covariances(sigma2)
    for d in range(D):
        v_d = covariances[:, d]
        with full_fp32():
            qv = q @ v_d
        rhs = torch.zeros((F, D, 1), dtype=q.dtype, device=q.device)
        rhs[:, d] = 1
        h = stable_solve(qv, rhs)[..., 0]  # (F, D)
        with full_fp32():
            norm2 = torch.einsum('fa,fab,fb->f', h.conj(), v_d, h).real
        h = h / torch.sqrt(torch.clamp(norm2, min=_EPS))[:, None]
        q = torch.cat([q[:, :d], h.conj()[:, None], q[:, d + 1:]], dim=1)
    return q


def _fca_fit(y, q, lam, v, *, iterations, q_iterations, eigenvalue_floor):
    profiling.count('fca.iterations', iterations)
    profiling.count('fca.ip_rows', y.shape[-2] * q_iterations * iterations)
    products = _FrameProducts(y)
    for _ in range(iterations):
        p, _ = _transformed_power(q, y)

        # MU for the source powers (IS-NMF rule on |z|^2).
        sigma2 = _sigma2(v, lam)
        ratio, inv = p / sigma2 ** 2, 1.0 / sigma2
        with full_fp32():
            num = torch.einsum('fkd,fdt->fkt', lam, ratio)
            den = torch.einsum('fkd,fdt->fkt', lam, inv)
        v = v * torch.sqrt(num / (den + _EPS)) + _EPS

        # MU for the spatial spectra.
        sigma2 = _sigma2(v, lam)
        ratio, inv = p / sigma2 ** 2, 1.0 / sigma2
        with full_fp32():
            num = torch.einsum('fkt,fdt->fkd', v, ratio)
            den = torch.einsum('fkt,fdt->fkd', v, inv)
        lam = lam * torch.sqrt(num / (den + _EPS))

        # Scale normalization (the per-source scale moves into the
        # powers; sigma2 is unchanged) and the full-rank floor.
        scale = lam.mean(-1, keepdim=True)
        lam = torch.clamp(lam / scale, min=eigenvalue_floor)
        v = v * scale

        # IP sweeps for the shared diagonalizer.
        sigma2 = _sigma2(v, lam)
        for _ in range(q_iterations):
            q = _ip_update(q, products, sigma2)
    return q, lam, v


class FCATrainer:
    """Fits :class:`FCA` by interleaved MU / IP updates.

    Args:
        q_iterations: IP sweeps over the D diagonalizer rows per
            iteration (1 is the FastMNMF default).
        eigenvalue_floor: lower bound of the normalized per-source
            spatial spectra (keeps every source full-rank).
    """

    def __init__(self, *, q_iterations=1, eigenvalue_floor=1e-6):
        self.q_iterations = q_iterations
        self.eigenvalue_floor = eigenvalue_floor

    @profiling.span('fca.fit')
    def fit(self, y, initialization=None, num_classes=None, iterations=50,
            *, generator=None) -> FCA:
        """Fit the model to one utterance (or to a batch folded into the
        bin axis).

        Args:
            y: (F, T, D) complex STFT observations.
            initialization: one of
                * None (then ``num_classes`` is required): random
                  log-normal spatial spectra and mildly randomized
                  uniform powers;
                * (F, K, T) real masks, e.g. a cACGMM ``fit_predict``
                  output: the powers start from the masked mixture
                  power;
                * an :class:`FCA` model: a warm start.
            num_classes: K (exclusive with ``initialization``).
            iterations: MU / IP iterations (> 0).
            generator: ``torch.Generator`` of the random initialization
                (required when ``initialization`` is None), on ``y``'s
                device.
        """
        assert (initialization is None) ^ (num_classes is None), (
            'Exactly one of initialization and num_classes must be '
            f'given: {initialization is None} xor {num_classes is None}'
        )
        assert y.is_complex(), y.dtype
        assert y.ndim == 3, y.shape
        assert 1 < y.shape[-1] < 35, f'Channels: {y.shape[-1]}, sure?'
        assert iterations > 0, iterations

        y_int = y.transpose(-2, -1)  # (F, D, T)
        F, D, T = y_int.shape
        rdtype = _real_dtype(y)
        device = y.device

        if isinstance(initialization, FCA):
            q0 = initialization.diagonalizer
            lam0 = initialization.eigenvalue
            v0 = initialization.power
        else:
            q0 = torch.eye(D, dtype=y.dtype, device=device).expand(F, D, D)
            mean_power = (y_int.real ** 2 + y_int.imag ** 2).mean(-2)
            if initialization is None:
                K = num_classes
                assert generator is not None, (
                    'generator is required for random initialization')
                warnings.warn(
                    'Blind FCA fit (initialization=None): the random '
                    'log-normal init escapes the symmetric stationary '
                    'point but still measures ~5x worse separation '
                    'MSE than warm-starting from mixture-model masks. '
                    'For production quality pass '
                    'initialization=<(F, K, T) masks>, e.g. a cACGMM '
                    'fit_predict output.',
                    stacklevel=2,
                )
                # per-(f, k, d) log-normal spatial spectra escape the
                # symmetric stationary point of a shared deterministic
                # init
                lam0 = torch.exp(torch.randn(
                    (F, K, D), generator=generator, dtype=rdtype,
                    device=device))
                perturbation = 0.75 + 0.5 * torch.rand(
                    (F, K, T), generator=generator, dtype=rdtype,
                    device=device)
                v0 = mean_power[:, None, :] * perturbation / K
            else:
                masks = torch.as_tensor(initialization, dtype=rdtype,
                                        device=device)
                assert masks.ndim == 3 and masks.shape[0] == F, (
                    masks.shape, y.shape)
                K = masks.shape[-2]
                lam0 = torch.ones((F, K, D), dtype=rdtype, device=device)
                v0 = masks * mean_power[:, None, :] + _EPS
        q, lam, v = _fca_fit(
            y_int, q0, lam0.to(rdtype), v0.to(rdtype),
            iterations=iterations, q_iterations=self.q_iterations,
            eigenvalue_floor=self.eigenvalue_floor)
        return FCA(diagonalizer=q, eigenvalue=lam, power=v)

    def fit_predict(self, y, **kwargs):
        """Fit, then return the (F, K, T) masks."""
        return self.fit(y, **kwargs).predict()
