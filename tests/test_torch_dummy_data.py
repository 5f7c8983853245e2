"""The port's synthetic scenarios are bit-equal to the JAX package's,
and its reader of a local pb_test_data checkout returns the JAX
package's arrays."""
import json

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


def _fake_pb_test_data(root):
    """A tiny pb_test_data checkout: bss_data/bss_data.json and int16
    wav files (the reference's schema, ${DB_DIR} paths)."""
    from scipy.io import wavfile
    rng = np.random.default_rng(0)
    data_dir = root / 'bss_data'
    entries = {}
    for example in ('low_reverberation', 'reverberation'):
        (data_dir / example).mkdir(parents=True)

        def wav(name, channels):
            samples = rng.integers(-2 ** 15, 2 ** 15, (400, channels),
                                   dtype=np.int16)
            wavfile.write(data_dir / example / name, 8000,
                          samples if channels > 1 else samples[:, 0])
            return '${DB_DIR}/' + f'{example}/{name}'

        entries[example] = dict(
            num_speakers=2,
            audio_path=dict(
                observation=wav('observation.wav', 6),
                speech_source=[wav('s0.wav', 1), wav('s1.wav', 1)],
                speech_image=[wav('i0.wav', 6), wav('i1.wav', 6)],
                noise_image=wav('noise.wav', 6)))
    (data_dir / 'bss_data.json').write_text(json.dumps(
        dict(datasets=dict(test=entries))))
    return data_dir


@pytest.mark.parametrize('point_at', ['root', 'bss_data'])
def test_real_audio_data_equals_jax(tmp_path, monkeypatch, point_at):
    data_dir = _fake_pb_test_data(tmp_path)
    monkeypatch.setenv('PB_BSS_TPU_TEST_DATA',
                       str(tmp_path if point_at == 'root' else data_dir))
    assert dummy_data.real_test_data_root() == \
        jax_dummy.real_test_data_root() == data_dir
    for example in ('low_reverberation', 'reverberation'):
        ours = dummy_data.real_audio_data(example)
        ref = jax_dummy.real_audio_data(example)
        assert ours.keys() == ref.keys()
        assert ours['example_id'] == example
        assert ours['sample_rate'] == ref['sample_rate'] == 8000
        assert ours['audio_path'] == ref['audio_path']
        audio = ours['audio_data']
        assert audio.keys() == ref['audio_data'].keys()
        for key, value in audio.items():
            assert value.dtype == np.float64
            np.testing.assert_array_equal(value, ref['audio_data'][key])
        assert audio['observation'].shape == (6, 400)
        assert audio['speech_source'].shape == (2, 400)
        assert audio['speech_image'].shape == (2, 6, 400)
        assert np.abs(audio['observation']).max() <= 1


def test_real_audio_data_needs_a_checkout(tmp_path, monkeypatch):
    """No variable, or one naming a directory without bss_data.json:
    no root, and FileNotFoundError in both packages (nothing is
    downloaded)."""
    for value in (None, str(tmp_path)):
        if value is None:
            monkeypatch.delenv('PB_BSS_TPU_TEST_DATA', raising=False)
        else:
            monkeypatch.setenv('PB_BSS_TPU_TEST_DATA', value)
        assert dummy_data.real_test_data_root() is None
        assert jax_dummy.real_test_data_root() is None
        for module in (dummy_data, jax_dummy):
            with pytest.raises(FileNotFoundError, match='PB_BSS_TPU'):
                module.real_audio_data('low_reverberation')
