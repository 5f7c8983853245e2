"""End-to-end separation example on the PyTorch port
(``pb_bss_tpu_torch``; the counterpart of mixture_model_example.py).

Pipeline: synthetic 2-speaker 6-channel mixture -> STFT -> cACGMM EM ->
DHTV permutation alignment -> (a) mask-based extraction and
(b) GEV beamforming -> metrics.

Every stage runs on the tensors' device: the card by default (the EM
fit in the whole-fit kernel, each class's GEV beamformer in the GEV
kernel), the CPU with ``--device cpu`` (the kernels' plain twins).

Run: python examples/mixture_model_example_torch.py [--reverb]
     [--device cpu]
"""
import argparse
import pathlib
import sys

# allow running the script directly from a repo checkout
sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

from pb_bss_tpu_torch.evaluation import InputMetrics, OutputMetrics
from pb_bss_tpu_torch.extraction import (
    apply_beamforming_vector,
    get_bf_vector,
    get_power_spectral_density_matrix,
)
from pb_bss_tpu_torch.models import CACGMMTrainer
from pb_bss_tpu_torch.permutation_alignment import DHTVPermutationAlignment
from pb_bss_tpu_torch.testing.dummy_data import (
    low_reverberation_data,
    reverberation_data,
)
from pb_bss_tpu_torch.transform import istft, stft


def _host(x):
    """A metric as a host array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def main(reverb=False, iterations=80, device='cuda'):
    device = torch.device(device)
    ex = reverberation_data() if reverb else low_reverberation_data()
    observation = torch.as_tensor(ex['observation'], dtype=torch.float32,
                                  device=device)              # (D, N)
    speech_source = ex['speech_source']                       # (K, N)
    sample_rate = ex['sample_rate']
    num_samples = observation.shape[-1]

    # --- stage 1: STFT + EM + posterior --------------------------------
    Observation = stft(observation, 512, 128)                 # (D, T, F)
    Y = Observation.permute(2, 1, 0)                          # (F, T, D)
    model = CACGMMTrainer().fit(
        Y, num_classes=3, iterations=iterations,
        generator=torch.Generator(device).manual_seed(0))
    affiliation = model.predict(Y)                            # (F, K, T)

    # --- stage 2: frequency permutation alignment ----------------------
    pa = DHTVPermutationAlignment.from_stft_size(512)
    masks = pa(affiliation.transpose(0, 1))                   # (K, F, T)

    # --- stage 3a: mask-based extraction --------------------------------
    masked = masks.transpose(1, 2) * Observation[0]           # (K, T, F)
    estimates = istft(masked, 512, 128)[..., :num_samples]

    metrics = OutputMetrics(
        speech_prediction=estimates,
        speech_source=speech_source,
        sample_rate=sample_rate,
        device=device,
    )
    print('mask-based extraction:')
    print('  mir_eval SDR:', np.round(_host(metrics.mir_eval_sdr), 2), 'dB')
    print('  selection:   ', _host(metrics.mir_eval_selection))

    # --- stage 3b: beamforming -------------------------------------------
    Y_fdt = Observation.permute(2, 0, 1)                      # (F, D, T)
    psds = get_power_spectral_density_matrix(
        Y_fdt, masks.transpose(0, 1))                         # (F, K, D, D)
    outs = []
    for k in range(3):
        phi_xx = psds[:, k]
        phi_nn = psds.sum(1) - phi_xx
        w = get_bf_vector('gev+ban', phi_xx, phi_nn)
        x_hat = apply_beamforming_vector(w, Y_fdt)            # (F, T)
        outs.append(istft(x_hat.T, 512, 128))
    beamformed = torch.stack(outs)[..., :num_samples]

    metrics_bf = OutputMetrics(
        speech_prediction=beamformed,
        speech_source=speech_source,
        sample_rate=sample_rate,
        device=device,
    )
    print('GEV+BAN beamforming:')
    print('  mir_eval SDR:', np.round(_host(metrics_bf.mir_eval_sdr), 2),
          'dB')

    # --- input metrics for reference -------------------------------------
    input_metrics = InputMetrics(
        observation=observation,
        speech_source=speech_source,
        sample_rate=sample_rate,
        device=device,
    )
    print('unprocessed observation (channel mean):')
    print('  mir_eval SDR:',
          np.round(_host(input_metrics.mir_eval_sdr).mean(-1), 2), 'dB')


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--reverb', action='store_true')
    parser.add_argument('--iterations', type=int, default=80)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    main(reverb=args.reverb, iterations=args.iterations, device=args.device)
