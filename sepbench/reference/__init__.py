"""Plain reference of what the benchmark drives. Separation, in
PyTorch: STFT, cACGMM EM, DHTV permutation alignment, the GEV
beamformer with blind analytic normalization, iSTFT, written from the
algorithms' definitions (Ito et al. 2016 for the cACGMM, Tran Vu and
Haeb-Umbach 2015 for DHTV, Warsitz and Haeb-Umbach 2007 for GEV and BAN)
with the conventions of the system under test where they fix a result
(framing, window, EM floors, tie-breaking); every matrix product goes
through :func:`precision.mm`, so the same code runs in float64 (the
judge) and with TF32 inputs (the control). Scoring, in NumPy:
``bss_eval`` and ``stoi``, copies of the system's float64 host oracles.
Nothing of the system under test is imported.
"""
from .beamformer import extract
from .cacgmm import cacgmm_em, initialization
from .dhtv import dhtv_mapping, apply_mapping
from .stft import istft, stft, stft_frames

__all__ = ['extract', 'cacgmm_em', 'initialization', 'dhtv_mapping',
           'apply_mapping', 'istft', 'stft', 'stft_frames']
