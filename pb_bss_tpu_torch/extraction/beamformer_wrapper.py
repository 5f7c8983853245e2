"""String-dispatch beamformer wrapper (counterpart of
``pb_bss_tpu.extraction.beamformer_wrapper``):
``get_bf_vector('rank1_gev+mvdr_souden+ban', ...)`` parses the ``+ban``
suffix and an optional rank-1 re-estimation of the target PSD
(``rank1_pca`` / ``rank1_gev``) or ATF estimate (``pca`` /
``scaled_gev_atf``) and dispatches to the estimators of
:mod:`.beamformer`; ``'chX'`` selects channel X. Also the rank-one
helpers."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import labels_to_one_hot
from .beamformer import (
    _trace,
    blind_analytic_normalization,
    get_gev_vector,
    get_mvdr_vector,
    get_mvdr_vector_souden,
    get_pca_vector,
    get_wmwf_vector,
)

__all__ = [
    'get_bf_vector',
]

_RANK1 = ('rank1_pca', 'rank1_gev')
_CORES = frozenset(
    ['pca', 'pca+mvdr', 'scaled_gev_atf+mvdr']
    + [f'{prefix}{estimator}' for estimator in ('mvdr_souden', 'gev', 'wmwf')
       for prefix in ('', 'rank1_pca+', 'rank1_gev+')])


def _rank_one(a, covariance_matrix):
    """``a a^H`` scaled to the trace of ``covariance_matrix``."""
    cov_rank1 = torch.einsum('...d,...D->...dD', a, a.conj())
    scale = _trace(covariance_matrix) / _trace(cov_rank1)
    return scale[..., None, None] * cov_rank1


def get_pca_rank_one_estimate(covariance_matrix, **atf_kwargs):
    """Rank-1 PSD approximation from the dominant eigenvector (Wang et
    al., "Rank-1 Constrained MWF", Eq. 25/26)."""
    return _rank_one(get_pca_vector(covariance_matrix, **atf_kwargs),
                     covariance_matrix)


def _get_gev_atf_vector(covariance_matrix, noise_covariance_matrix,
                        **gev_kwargs):
    """Scaled ATF estimate from the dominant generalized eigenvector
    (https://arxiv.org/pdf/1707.00201.pdf Eq. 27)."""
    assert noise_covariance_matrix is not None
    w = get_gev_vector(covariance_matrix, noise_covariance_matrix,
                       **gev_kwargs)
    return torch.einsum('...dD,...D->...d', noise_covariance_matrix, w)


def get_gev_rank_one_estimate(covariance_matrix, noise_covariance_matrix,
                              **gev_kwargs):
    """Rank-1 PSD approximation from the GEV-based ATF."""
    return _rank_one(_get_gev_atf_vector(
        covariance_matrix, noise_covariance_matrix, **gev_kwargs),
        covariance_matrix)


def _get_atf_vector(atf_type, target_psd_matrix, noise_psd_matrix,
                    **atf_kwargs):
    if atf_type == 'pca':
        return get_pca_vector(target_psd_matrix, **atf_kwargs)
    if atf_type == 'scaled_gev_atf':
        return _get_gev_atf_vector(target_psd_matrix, noise_psd_matrix,
                                   **atf_kwargs)
    raise ValueError(atf_type, 'use either pca or scaled_gev_atf')


def _get_rank_1_approximation(atf_type, target_psd_matrix, noise_psd_matrix,
                              **atf_kwargs):
    if atf_type == 'rank1_pca':
        return get_pca_rank_one_estimate(target_psd_matrix, **atf_kwargs)
    if atf_type == 'rank1_gev':
        return get_gev_rank_one_estimate(target_psd_matrix, noise_psd_matrix,
                                         **atf_kwargs)
    raise ValueError(atf_type, 'use either rank1_pca or rank1_gev')


def _get_response_vector(source_index, num_sources, epsilon=0.):
    response_vector = labels_to_one_hot(
        np.array(source_index), num_sources, dtype=np.float64)
    return np.clip(response_vector, epsilon, 1.)


def parse_beamformer(beamformer):
    """``(core, ban)`` of a :func:`get_bf_vector` name; raises as
    :func:`get_bf_vector` does for a name it does not take (an
    ``AssertionError`` for LCMV, a ``ValueError`` for an unknown name),
    so that callers can check a name before any work."""
    assert isinstance(beamformer, str), beamformer
    assert 'lcmv' not in beamformer, (
        'LCMV takes per-source PSD stacks plus a response vector, which '
        'does not fit this single-target dispatch — call '
        '`pb_bss_tpu_torch.extraction.get_lcmv_vector` (or '
        '`get_lcmv_vector_souden`) directly.'
    )
    ban = beamformer.endswith('+ban')
    core = beamformer[:-len('+ban')] if ban else beamformer
    if core not in _CORES and not (core.startswith('ch')
                                   and core[2:].isdigit()):
        raise ValueError(
            f'Could not find implementation for {core}.\n'
            f'Original call contained {beamformer}.'
        )
    return core, ban


def get_bf_vector(beamformer, target_psd_matrix, noise_psd_matrix=None,
                  **bf_kwargs):
    """Obtain a beamforming vector by name.

    Names: ``'pca'``, ``'pca+mvdr'``, ``'scaled_gev_atf+mvdr'``,
    ``'mvdr_souden'``, ``'gev'`` and ``'wmwf'``, the last three also
    after ``'rank1_pca+'`` or ``'rank1_gev+'``, ``'chX'``; each with an
    optional ``'+ban'`` suffix (blind analytic normalization).

    Args:
        beamformer: the '+'-separated name.
        target_psd_matrix: (..., sensor, sensor).
        noise_psd_matrix: (..., sensor, sensor).
        **bf_kwargs: forwarded to the core estimator; ATF options under
            the ``atf_kwargs`` key.
    """
    core, ban = parse_beamformer(beamformer)
    if core == 'pca':
        vector = get_pca_vector(target_psd_matrix, **bf_kwargs)
    elif core in ('pca+mvdr', 'scaled_gev_atf+mvdr'):
        atf_vector = _get_atf_vector(
            core.split('+')[0], target_psd_matrix, noise_psd_matrix,
            **bf_kwargs.pop('atf_kwargs', {}))
        vector = get_mvdr_vector(atf_vector, noise_psd_matrix)
    elif core.startswith('ch'):
        D = target_psd_matrix.shape[-1]
        vector = torch.zeros(D, dtype=target_psd_matrix.dtype,
                             device=target_psd_matrix.device)
        vector[int(core[2:])] = 1
        vector = vector.expand(target_psd_matrix.shape[:-1])
    else:
        rank1, _, estimator = core.rpartition('+')
        if rank1:
            target_psd_matrix = _get_rank_1_approximation(
                rank1, target_psd_matrix, noise_psd_matrix,
                **bf_kwargs.pop('atf_kwargs', {}))
        vector = {'mvdr_souden': get_mvdr_vector_souden,
                  'gev': get_gev_vector,
                  'wmwf': get_wmwf_vector}[estimator](
            target_psd_matrix, noise_psd_matrix, **bf_kwargs)
    if ban:
        vector = blind_analytic_normalization(vector, noise_psd_matrix)
    return vector
