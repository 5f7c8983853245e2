"""String-dispatch beamformer wrapper (counterpart of
``pb_bss_tpu.extraction.beamformer_wrapper``) for the beamformers the
port has so far: ``'gev'`` and ``'gev+ban'``."""
from __future__ import annotations

from .beamformer import blind_analytic_normalization, get_gev_vector

__all__ = ['get_bf_vector']


def get_bf_vector(beamformer, target_psd_matrix, noise_psd_matrix=None):
    """Obtain a beamforming vector by name.

    Args:
        beamformer: ``'gev'`` or ``'gev+ban'``; the JAX package's other
            names (MVDR, PCA, wMWF, rank-1 variants, ``'chX'``) raise
            ``NotImplementedError`` until they are ported.
        target_psd_matrix: (..., sensor, sensor).
        noise_psd_matrix: (..., sensor, sensor).
    """
    assert isinstance(beamformer, str), beamformer
    ban = beamformer.endswith('+ban')
    core = beamformer[:-len('+ban')] if ban else beamformer
    if core != 'gev':
        raise NotImplementedError(
            f'beamformer {beamformer!r} is not ported yet (ROADMAP queue '
            "1, extraction); available: 'gev', 'gev+ban'")
    vector = get_gev_vector(target_psd_matrix, noise_psd_matrix)
    if ban:
        vector = blind_analytic_normalization(vector, noise_psd_matrix)
    return vector
