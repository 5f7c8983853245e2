from .beamformer import (  # noqa: F401
    apply_beamforming_vector,
    blind_analytic_normalization,
    get_gev_vector,
    get_power_spectral_density_matrix,
    phase_correction,
)
from .beamformer_wrapper import get_bf_vector  # noqa: F401
