"""The work an algorithm needs, counted from shapes, and the H100's
published peaks.

``bound``, ``nbytes``, ``em_flops`` and ``jacobi_flops`` are copies of
the system's smoke-test arithmetic, kept here so that the yardstick
cannot move with the program. The counts are of the algorithm, not of a
kernel: a rewritten kernel is held to the same work.
"""
from __future__ import annotations

import math

# published peaks of the H100 SXM (the least time of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the memory rate and the float32 operations
    over the float32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# float32 operations of the EM pieces, as the function needs them (a
# complex multiply-add is 8): a frame's products y_d conj(y_e) over the
# upper triangle once per frame, shared by the classes, the E-step and
# the scatter (3 per diagonal entry, 6 per pair); per (frame, class) the
# quadratic form as the projection on the scaled eigenbasis (8 per complex
# multiply-add, D^2 of them, and 3 per |z_i|^2), plus ~10 for the log-pdf
# and softmax, and 4 per entry for the scatter; a Jacobi rotation updates
# two rows and two columns of A and two columns of V (10 per entry) after
# ~30 for its parameters.
def em_flops(frames, K, D, e_step=True, scatter=True, form='projection'):
    P = D * (D + 1) // 2
    quadratic = 8 * D * D + 3 * D if form == 'projection' else 4 * P
    per_class = (quadratic + 10 if e_step else 0) \
        + (4 * P if scatter else 0)
    return frames * (3 * D + 6 * (P - D) + K * per_class)


def jacobi_flops(matrices, D, sweeps):
    return matrices * sweeps * D * (D - 1) // 2 * (60 * D + 30)


def fft_flops(size, transforms):
    """A real transform of ``size`` points: half of a complex one's
    5 N log2 N."""
    return transforms * 2.5 * size * math.log2(size)


def em_work(config, batch):
    """(flops, bytes) of the cACGMM fit of one batch: ``iterations``
    E-steps and scatters over every frame of every bin, one
    eigendecomposition per (bin, class) and M-step (the first cold, 6
    sweeps; the later ones warm, 2 sweeps after the rotation V^H A V,
    16 D^3); bytes as the observations and the initial affiliations read
    once and the affiliations and the model written once (float32,
    complex64)."""
    D, K, it = config['channels'], config['num_classes'], \
        config['iterations']
    F = config['stft_size'] // 2 + 1
    T = frames(config)
    n = batch * F
    flops = it * em_flops(n * T, K, D) + jacobi_flops(n * K, D, 6) \
        + (it - 1) * (jacobi_flops(n * K, D, 2) + n * K * 16 * D ** 3)
    moved = n * T * D * 8 + 2 * n * K * T * 4 \
        + n * K * (1 + D + D * D * 2) * 4
    return flops, moved


def frames(config):
    size, shift = config['stft_size'], config['stft_shift']
    padded = config['samples'] + 2 * (size - shift)
    return max(1, math.ceil((padded - size + shift) / shift))


def separation_flops(config, batch):
    """float32 operations of one ``separate_batch`` call: the STFT of
    every channel and the iSTFT of every class, the EM (:func:`em_work`),
    the PSDs (the products y y^H once per frame, 4 per upper-triangle
    entry and class for the masked sums), one GEV per (utterance, class,
    bin) (Cholesky D^3 / 3 and two triangular solves D^3 complex, 8 per
    multiply-add, a 6-sweep Jacobi, the back-substitution), and the
    beamformer's output (8 D per frame and class). DHTV's scores are
    left out: its iterations depend on the data and are under 1% of the
    rest."""
    D, K = config['channels'], config['num_classes']
    size = config['stft_size']
    F = size // 2 + 1
    T = frames(config)
    n = batch * F
    P = D * (D + 1) // 2
    stft = fft_flops(size, batch * D * T) + fft_flops(size, batch * K * T)
    psd = n * T * (3 * D + 6 * (P - D) + K * 4 * P)
    gev = n * K * (8 * (D ** 3 / 3 + D ** 3 + D * D)) \
        + jacobi_flops(n * K, D, 6)
    apply = n * K * T * 8 * D
    return stft + em_work(config, batch)[0] + psd + gev + apply


__all__ = ['bound', 'nbytes', 'em_flops', 'jacobi_flops', 'fft_flops',
           'em_work', 'frames', 'separation_flops', 'PEAK_BYTES_PER_S',
           'PEAK_FP32_FLOP_PER_S']
