"""The port's synthetic scenarios are bit-equal to the JAX package's."""
import numpy as np
import pytest

from pb_bss_tpu.testing import dummy_data as jax_dummy
from pb_bss_tpu_torch.testing import dummy_data


@pytest.mark.parametrize('seed', [0, 5, 23])
def test_bit_equal(seed):
    ours = dummy_data.low_reverberation_data(seed)
    ref = jax_dummy.low_reverberation_data(seed)
    assert ours['sample_rate'] == ref['sample_rate'] == 8000
    for key in ('observation', 'speech_source', 'speech_image',
                'noise_image'):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
    assert ours['observation'].shape == (6, 38520)


@pytest.mark.parametrize('seed', [1, 7])
def test_reverberation_data_bit_equal(seed):
    ours = dummy_data.reverberation_data(seed)
    ref = jax_dummy.reverberation_data(seed)
    assert ours['sample_rate'] == ref['sample_rate'] == 8000
    for key in ('observation', 'speech_source', 'speech_image',
                'noise_image'):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
        np.testing.assert_array_equal(ours['audio_data'][key], ref[key])
    assert ours['speech_image'].shape == (2, 6, 38520)
