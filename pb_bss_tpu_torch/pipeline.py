"""High-level separation pipeline.

The standard recipe — STFT -> spatial mixture model EM (cACGMM, the
complex Watson mixture with ``model='cwmm'`` or the complex Bingham
mixture with ``model='cbmm'``) -> DHTV permutation
alignment -> mask-based extraction, any beamformer of
:func:`~pb_bss_tpu_torch.extraction.get_bf_vector` or the FCA refinement
-> iSTFT — as :func:`separate` (one utterance) and
:func:`separate_batch` (a leading batch axis through every stage).
Counterpart of ``pb_bss_tpu.pipeline``.
On the card the EM runs one whole-fit launch for recordings inside its
gate and the streamed route (one statistics launch per iteration) for
longer ones, such as a minute at 8 kHz (T = 3753 frames: past the
cACGMM kernel's gate and, by three frames, the Bingham one's; the Watson
whole-fit kernel still takes it at D=6, K=3).
"""
from __future__ import annotations

import torch

from .extraction.beamformer import (
    apply_beamforming_vector,
    get_power_spectral_density_matrix,
    phase_correction,
)
from .extraction.beamformer_wrapper import get_bf_vector, parse_beamformer
from .models.cacgmm import CACGMMTrainer
from .models.cbmm import CBMMTrainer
from .models.cwmm import CWMMTrainer
from .models.fca import FCATrainer
from ._shard import (
    axis_shard,
    frequency_gather,
    frequency_rows,
    frequency_sharded,
)
from .permutation_alignment import DHTVPermutationAlignment
from .transform import istft, stft
from .transform.stft_module import stft_frames

__all__ = ['separate', 'separate_batch']


def _check_options(beamformer, model, mesh, refine, device):
    if refine is not None:
        if refine != 'fca':
            raise ValueError(f'Unknown refine stage: {refine!r}')
        if beamformer is not None:
            raise ValueError(
                'refine and beamformer are mutually exclusive, got '
                f'refine={refine!r}, beamformer={beamformer!r}')
    if model not in ('cacgmm', 'cwmm', 'cbmm'):
        raise ValueError(model)
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f'mesh must be a DeviceMesh, got {mesh!r}')
        names = mesh.mesh_dim_names or ()
        if not names or not set(names) <= {'b', 'f'}:
            raise ValueError(
                f"mesh axes must be 'b' and / or 'f', got {names}")
        if mesh.device_type != device.type:
            raise ValueError(f'a {mesh.device_type} mesh cannot shard '
                             f'observations on {device}')
    if beamformer is not None:
        parse_beamformer(beamformer)


def _random_affiliation(generator, shape, dtype, device):
    """The trainer's random initialization: uniform, normalized over
    classes."""
    affiliation = torch.rand(shape, generator=generator, dtype=dtype,
                             device=device)
    return affiliation / affiliation.sum(-2, keepdim=True)


def _separate(observations, initialization, *, iterations, stft_size,
              stft_shift, beamformer, reference_channel, eigh_sweeps, model,
              refine, refine_iterations, mesh=None, batch_sharded=True):
    """observations (B, D, N), initialization (B, F, K, T) ->
    (B, K, N).

    With a ``mesh``, every rank takes its utterances over ``'b'`` (the
    rows of ``initialization`` too, which holds the whole batch) and its
    bins over ``'f'``: the fit and the extraction run on them, the
    affiliations and the beamforming vectors are gathered over ``'f'``
    for the steps that walk every bin (DHTV, the phase correction; both
    replicated on the ranks), the reference-channel SNR is all-reduced
    over ``'f'`` (``_shard.frequency_sum``), and the per-class spectra
    and the waveforms are gathered before they are returned. Without a
    mesh the gathers and slices are the identity.
    """
    num_samples = observations.shape[-1]
    batch = axis_shard(mesh, 'b', observations.shape[0]) \
        if batch_sharded else None
    if batch is not None:
        observations = batch.rows(observations, 0)
        initialization = batch.rows(initialization, 0)
    bins = axis_shard(mesh, 'f', stft_size // 2 + 1)
    with frequency_sharded(bins):
        out = _separate_bins(
            observations, initialization, iterations=iterations,
            stft_size=stft_size, stft_shift=stft_shift,
            beamformer=beamformer, reference_channel=reference_channel,
            eigh_sweeps=eigh_sweeps, model=model, refine=refine,
            refine_iterations=refine_iterations)
        out = istft(frequency_gather(out, -1), stft_size, stft_shift,
                    num_samples=num_samples)  # (B, K, N)
    return out if batch is None else batch.gather(out, 0)


def _separate_bins(observations, initialization, *, iterations, stft_size,
                   stft_shift, beamformer, reference_channel, eigh_sweeps,
                   model, refine, refine_iterations):
    """The pipeline up to the synthesis on this rank's bins (all bins
    outside :func:`~pb_bss_tpu_torch._shard.frequency_sharded`):
    observations (B, D, N), initialization (B, F, K, T) of every bin ->
    the per-class spectra (B, K, T, F) of this rank's bins."""
    Observation = frequency_rows(
        stft(observations, stft_size, stft_shift), -1)  # (B, D, T, F)
    Y = Observation.permute(0, 3, 2, 1)  # (B, F, T, D)
    initialization = frequency_rows(initialization, 1)
    if model == 'cwmm':
        affiliation = CWMMTrainer().fit_predict(
            Y, initialization=initialization, iterations=iterations)
    elif model == 'cbmm':
        affiliation = CBMMTrainer().fit_predict(
            Y, initialization=initialization, iterations=iterations)
    else:
        _, affiliation = CACGMMTrainer().fit_predict_model(
            Y, initialization=initialization, iterations=iterations,
            eigh_sweeps=eigh_sweeps)  # (B, F, K, T)
    pa = DHTVPermutationAlignment.from_stft_size(stft_size)
    # DHTV walks overlapping segments of every bin
    masks = frequency_rows(
        pa(frequency_gather(affiliation.transpose(1, 2), 2)),
        2)  # (B, K, F, T)

    if refine is not None:
        # every bin is independent: the batch folds into the bin axis
        B, F, T, D = Y.shape
        fca = FCATrainer().fit(
            Y.reshape(B * F, T, D),
            initialization=masks.transpose(1, 2).reshape(B * F, -1, T),
            iterations=refine_iterations)
        images = fca.separate(Y.reshape(B * F, T, D))  # (B F, K, T, D)
        estimate = images[..., reference_channel].reshape(B, F, -1, T)
        return estimate.permute(0, 2, 3, 1)

    if beamformer is None:
        return masks.transpose(-1, -2) \
            * Observation[:, reference_channel, None]  # (B, K, T, F)

    Y_fdt = Observation.permute(0, 3, 1, 2)  # (B, F, D, T)
    psds = get_power_spectral_density_matrix(
        Y_fdt, masks.transpose(1, 2))  # (B, F, K, D, D)
    phi_nn = psds.sum(2, keepdim=True) - psds
    # every class of every bin in one call (pencils are independent), as
    # (B, K, F, D, D): the MVDR-Souden and wMWF beamformers pick their
    # reference channel per utterance and class, over the bins
    w = get_bf_vector(beamformer, psds.transpose(1, 2),
                      phi_nn.transpose(1, 2))  # (B, K, F, D)
    # eigenvector-based beamformers carry an arbitrary phase per bin;
    # align phases across bins (a walk over every bin) before the
    # synthesis
    w = frequency_rows(phase_correction(frequency_gather(w, 2)), 2)
    out = apply_beamforming_vector(w, Y_fdt[:, None])  # (B, K, F, T)
    return out.transpose(-1, -2)


def _init_shape(observation, num_classes, stft_size, stft_shift):
    """(F, K, T) of the EM initialization for one utterance."""
    frames = stft_frames(observation.shape[-1], stft_size, stft_shift)
    return (stft_size // 2 + 1, num_classes, frames)


def separate(observation, *, num_classes=3, iterations=80, stft_size=512,
             stft_shift=128, beamformer=None, reference_channel=0,
             generator=None, eigh_sweeps=None, model='cacgmm', mesh=None,
             refine=None, refine_iterations=20):
    """Blind source separation of a multichannel recording.

    Args:
        observation: (D, num_samples) real tensor; the computation runs
            on its device.
        num_classes: number of mixture components (speakers + noise).
        iterations: EM iterations.
        beamformer: None for mask-based extraction at
            ``reference_channel``, or a
            :func:`~pb_bss_tpu_torch.extraction.get_bf_vector` name (e.g.
            ``'gev+ban'``, ``'mvdr_souden+ban'``,
            ``'rank1_gev+mvdr_souden+ban'``, ``'wmwf'``, ``'ch0'``)
            applied per class with the summed other classes as noise.
        generator: ``torch.Generator`` for the EM initialization
            (default: one seeded 0 on the observation's device).
        eigh_sweeps: optional Jacobi sweeps of the EM eigh.
        model: the spatial mixture model: ``'cacgmm'`` (default),
            ``'cwmm'`` (complex Watson) or ``'cbmm'`` (complex Bingham).
        mesh: optional ``DeviceMesh``
            (:func:`pb_bss_tpu_torch.parallel.make_mesh`) with an ``'f'``
            axis: every rank of ``'f'`` computes the STFT and keeps its
            frequency bins, and the EM, DHTV's masks and the extraction
            are partitioned over the bins (sequence parallelism; DHTV and
            the phase correction run on the gathered bins, replicated).
            Every rank returns the whole result. The mesh lives on the
            observation's device type (NCCL on CUDA, gloo on the CPU).
        refine: ``'fca'`` replaces the mask or beamformer extraction
            with a full-rank Wiener stage: the aligned masks warm-start
            an :class:`~pb_bss_tpu_torch.models.fca.FCA` fit, and the
            output is its Wiener source image at ``reference_channel``.
            Mutually exclusive with ``beamformer``.
        refine_iterations: MU / IP iterations of the refinement fit.
    Returns:
        (num_classes, num_samples) separated time signals (global class
        order is arbitrary).
    """
    assert observation.ndim == 2, observation.shape
    _check_options(beamformer, model, mesh, refine, observation.device)
    if generator is None:
        generator = torch.Generator(observation.device).manual_seed(0)
    dtype = torch.float64 if observation.dtype == torch.float64 \
        else torch.float32
    init = _random_affiliation(
        generator,
        _init_shape(observation, num_classes, stft_size, stft_shift),
        dtype, observation.device)
    return _separate(
        observation[None], init[None], iterations=iterations,
        stft_size=stft_size, stft_shift=stft_shift, beamformer=beamformer,
        reference_channel=reference_channel, eigh_sweeps=eigh_sweeps,
        model=model, refine=refine,
        refine_iterations=refine_iterations, mesh=mesh,
        batch_sharded=False)[0]


def utterance_generators(generator, batch, device):
    """One generator per utterance, seeded from ``generator`` (the
    counterpart of splitting a jax key): ``separate(observations[i],
    generator=utterance_generators(g, B, device)[i])`` draws exactly
    the initialization ``separate_batch(observations, generator=g)``
    uses for utterance i."""
    seeds = torch.randint(0, 2 ** 62, (batch,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device).manual_seed(s) for s in seeds]


def separate_batch(observations, *, num_classes=3, iterations=80,
                   stft_size=512, stft_shift=128, beamformer=None,
                   reference_channel=0, generator=None, eigh_sweeps=None,
                   model='cacgmm', mesh=None, refine=None,
                   refine_iterations=20):
    """Batched :func:`separate`: (B, D, num_samples) ->
    (B, num_classes, num_samples). The batch is a leading axis through
    every stage (the EM kernels, the beamformer's kernels and the FCA
    refinement, whose bins fold the batch, take the whole batch).
    Utterance i is initialized from the i-th of
    :func:`utterance_generators` (default master: seeded 0).

    With ``mesh`` the batch is split over the mesh's ``'b'`` axis (data
    parallel: utterances are independent, so the ranks exchange nothing
    until the result); an ``'f'`` axis additionally splits each
    utterance's pipeline over frequency bins, as in :func:`separate`
    (full 2D ('b', 'f') partitioning of stft -> EM -> PA -> beamform ->
    istft). Every rank draws the initialization of the whole batch and
    keeps its utterances and bins, so each utterance starts from what
    the unsharded call draws for it; every rank returns the whole
    (B, num_classes, num_samples) result.

    Args:
        observations: (B, D, num_samples) real multichannel signals.
        mesh: optional ``DeviceMesh`` with ``'b'`` and / or ``'f'``
            axes (:func:`pb_bss_tpu_torch.parallel.make_mesh`).
        (other args as in :func:`separate`)
    """
    assert observations.ndim == 3, observations.shape
    _check_options(beamformer, model, mesh, refine, observations.device)
    device = observations.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    dtype = torch.float64 if observations.dtype == torch.float64 \
        else torch.float32
    shape = _init_shape(observations[0], num_classes, stft_size, stft_shift)
    init = torch.stack([
        _random_affiliation(g, shape, dtype, device)
        for g in utterance_generators(
            generator, observations.shape[0], device)])
    return _separate(
        observations, init, iterations=iterations, stft_size=stft_size,
        stft_shift=stft_shift, beamformer=beamformer,
        reference_channel=reference_channel, eigh_sweeps=eigh_sweeps,
        model=model, refine=refine, refine_iterations=refine_iterations,
        mesh=mesh)
