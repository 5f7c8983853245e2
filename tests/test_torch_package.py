"""Package-level properties of pb_bss_tpu_torch: it imports no jax,
builds nothing at import, its kernel wrappers run their plain twins on
CPU tensors without counting a launch, and its kernel build names only
Hopper and the package's own CUDA sources."""
import pathlib
import re
import subprocess
import sys

import torch

from pb_bss_tpu_torch.ops import _build

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / 'pb_bss_tpu_torch'

_PROBE = r'''
import sys
import torch
import pb_bss_tpu_torch
from pb_bss_tpu_torch import (cli, permutation_alignment, pipeline)
from pb_bss_tpu_torch.evaluation import (
    _fused_eval_device, batch_wrapper, module_bss_eval,
    module_bss_eval_device, module_mir_eval, module_pesq, module_si_sdr,
    module_srmr, module_srmr_device, module_stoi, module_stoi_device,
    sxr_module, wrapper)
from pb_bss_tpu_torch.extraction import (
    beamform_utils, beamformer, beamformer_wrapper, mask_module)
from pb_bss_tpu_torch.math import solve
from pb_bss_tpu_torch.models import (
    base, cacgmm, cacgmm_streaming, complex_angular_central_gaussian,
    complex_circular_symmetric_gaussian, complex_watson, cwmm, fca,
    gaussian, gcacgmm, gmm, mixture_model_utils, vmfcacgmm, vmfmm,
    von_mises_fisher)
from pb_bss_tpu_torch import initializer, parallel, streaming, utils
from pb_bss_tpu_torch import _shard
from pb_bss_tpu_torch.initializer import deflation, deterministic, iid
from pb_bss_tpu_torch.utils import checkpoint, profiling
from pb_bss_tpu_torch.testing import (
    module_asserts, random_utils, streaming_quality)
from pb_bss_tpu_torch.distribution.utils import stack_parameters
from pb_bss_tpu_torch.ops import (
    _build, cwmm_loop, em_loop, gev, integration_em, integration_em_loop,
    linalg, mm_stream)
from pb_bss_tpu_torch.testing import dummy_data
from pb_bss_tpu_torch.transform import (
    filters, gammatone, griffin_lim_module, stft_module)
from pb_bss_tpu_torch import _device
assert 'jax' not in sys.modules, 'jax was imported'
assert 'torch.distributed.tensor' not in sys.modules, 'DTensor at import'
assert 'pb_bss_tpu' not in sys.modules, 'pb_bss_tpu was imported'
assert _build.load.cache_info().currsize == 0, 'a kernel was loaded'

g = torch.Generator().manual_seed(0)
y = torch.randn((4, 6, 20), dtype=torch.complex64, generator=g)
y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
aff = torch.rand((4, 3, 20), generator=g)
aff = aff / aff.sum(-2, keepdim=True)
out = em_loop.cacgmm_em_full(y, aff, torch.ones_like(aff), iterations=2)
assert out[3].shape == (4, 3, 20)
a = torch.randn((5, 6, 6), dtype=torch.complex64, generator=g)
phi = a @ a.conj().transpose(-1, -2)
assert gev.gev(phi, phi + torch.eye(6)).shape == (5, 6)
out = cwmm_loop.cwmm_em_full(y, aff, iterations=2)
assert out[3].shape == (4, 3, 20)
out = mm_stream.cwmm_em_long(y, aff, iterations=2)
assert out[1].shape == (4, 3, 6)
obs = torch.randn((4, 20, 6), dtype=torch.complex64, generator=g)
emb = torch.randn((4, 20, 5), generator=g)
for trainer, kw in ((vmfcacgmm.VMFCACGMMTrainer(), {}),
                    (gcacgmm.GCACGMMTrainer(),
                     dict(covariance_type='diagonal'))):
    for route in (True, 'loop'):
        model = trainer.fit(obs, emb, num_classes=3, iterations=3,
                            use_fused_em=route, **kw)
        assert model.predict(obs, emb).shape == (4, 3, 20)
phi_nn = phi + torch.eye(6)
for name in ('rank1_gev+mvdr_souden+ban', 'pca+mvdr', 'wmwf'):
    assert beamformer_wrapper.get_bf_vector(name, phi, phi_nn).shape == (5, 6)
y = torch.randn((5, 20, 3), dtype=torch.complex64, generator=g)
masks = torch.full((5, 2, 20), 0.5)
assert fca.FCATrainer().fit(y, initialization=masks,
                            iterations=1).predict().shape == (5, 2, 20)
import numpy as np
sep = streaming.StreamingSeparator(num_classes=2, init_frames=32,
                                   beamformer='gev+ban', device='cpu')
x = np.random.default_rng(0).standard_normal((3, 128 * 16 * 4))
assert np.isfinite(np.concatenate(
    [sep.process(x.astype(np.float32)), sep.flush()], -1)).all()
refs = np.random.default_rng(1).standard_normal((2, 3, 2, 4000))
m = batch_wrapper.OutputMetricsBatch(
    torch.as_tensor(refs[:, :, :, :]) + 0.1, refs, sample_rate=8000,
    device='cpu').as_dict()
assert m['mir_eval_sdr'].shape == (2, 3, 2)
assert gammatone.gammatone_filterbank(
    torch.as_tensor(refs[0, 0]), 8000, n=4).shape == (4, 2, 4000)
from pb_bss_tpu_torch.ops import eigh
assert eigh.eigh_jacobi.launches == 0
assert integration_em.e_stats.launches == 0
assert integration_em_loop.integration_em_full.launches == 0
assert em_loop.cacgmm_em_full.launches == 0
assert gev.gev.launches == 0
assert cwmm_loop.cwmm_em_full.launches == 0
assert mm_stream.mm_stats.launches == 0
print('ok')
'''


def test_imports_without_jax_and_plain_paths_count_no_launch():
    result = subprocess.run(
        [sys.executable, '-c', _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'


def test_no_jax_import_in_the_sources():
    forbidden = re.compile(
        r'^\s*(import|from)\s+(jax|pb_bss_tpu)(\.|\s|$)', re.M)
    for path in PACKAGE.rglob('*.py'):
        assert not forbidden.search(path.read_text()), path


def test_nvcc_command_targets_hopper_and_the_package_sources():
    for name in _build.KERNELS:
        cmd = _build.nvcc_command(name, output='/dev/null')
        assert 'arch=compute_90a,code=sm_90a' in cmd
        assert cmd[cmd.index('-gencode') + 1] == \
            'arch=compute_90a,code=sm_90a'
        for flag in ('-shared', '-fPIC', '-std=c++17', '-O3'):
            assert flag in cmd, flag
        assert '--use_fast_math' not in cmd
        sources = [pathlib.Path(c) for c in cmd if c.endswith('.cu')]
        assert sources == [_build.CSRC / f'{name}.cu']
        for source in sources:
            assert source.is_file()
            assert source.resolve().parent == PACKAGE / 'csrc'


def test_library_name_follows_the_sources():
    """An edited kernel source gives a new library name, so a stale
    build is never loaded."""
    paths = {name: _build._library_path(name) for name in _build.KERNELS}
    assert len(set(paths.values())) == len(paths)
    for path in paths.values():
        assert path.parent == PACKAGE / '_kernels'


def test_every_jax_model_name_has_a_counterpart():
    """Every name pb_bss_tpu.models exports exists in
    pb_bss_tpu_torch.models; the root exposes the distribution aliases,
    the aligners, the streaming separator and the subpackages."""
    import pb_bss_tpu.models as jax_models
    import pb_bss_tpu_torch
    import pb_bss_tpu_torch.models as models
    jax_names = {n for n in dir(jax_models) if not n.startswith('_')}
    missing = sorted(n for n in jax_names if not hasattr(models, n))
    assert not missing, missing
    assert pb_bss_tpu_torch.distribution is models
    assert sys.modules['pb_bss_tpu_torch.distribution'] is models
    assert sys.modules['pb_bss_tpu_torch.distribution.utils'] is models.base
    from pb_bss_tpu_torch.distribution.utils import (  # noqa: F401
        get_trainer_class_from_model,
        parameter_from_dict,
    )
    for name in ('StreamingSeparator', 'DHTVPermutationAlignment',
                 'GreedyPermutationAlignment', 'OraclePermutationAlignment',
                 'separate', 'separate_batch', 'utils', 'pipeline',
                 'streaming', 'math', 'ops', 'initializer',
                 'permutation_alignment', 'extraction', 'evaluation',
                 'transform', 'models', 'distribution'):
        assert hasattr(pb_bss_tpu_torch, name), name


def test_every_public_name_of_every_jax_module_has_a_counterpart():
    """A name-by-name diff of ``__all__``: every module of pb_bss_tpu
    (the Pallas kernels, ``native`` and ``__main__`` aside) has a
    counterpart in pb_bss_tpu_torch that exports each of its names; the
    root exposes ``parallel`` as the JAX package's does."""
    import importlib
    import pkgutil
    import pb_bss_tpu
    import pb_bss_tpu_torch
    missing = {}
    for info in pkgutil.walk_packages(pb_bss_tpu.__path__, 'pb_bss_tpu.'):
        name = info.name
        if '.pallas_' in name or name.startswith('pb_bss_tpu.native') \
                or name.endswith('__main__'):
            continue
        names = getattr(importlib.import_module(name), '__all__', ())
        port = importlib.import_module(
            name.replace('pb_bss_tpu', 'pb_bss_tpu_torch', 1))
        gone = [n for n in names if not hasattr(port, n)]
        if gone:
            missing[name] = gone
    assert not missing, missing
    assert pb_bss_tpu_torch.parallel.__all__ == pb_bss_tpu.parallel.__all__
    from pb_bss_tpu_torch.initializer.deflation import (  # noqa: F401
        deflationSeed)
    from pb_bss_tpu_torch.initializer.deterministic import flag  # noqa
    from pb_bss_tpu_torch.models.base import (  # noqa: F401
        _frequency_norm, _phase_norm, _unit_norm)
    from pb_bss_tpu_torch.testing.dummy_data import (  # noqa: F401
        real_audio_data, real_test_data_root)
    from pb_bss_tpu_torch.utils.profiling import Timer, trace  # noqa


def test_every_jax_evaluation_and_transform_name_has_a_counterpart():
    """Every public name of pb_bss_tpu.evaluation / .transform (the
    STFT's TPU-only ``method=`` aside) exists in the port; the
    functions of the device programs take ``device=``."""
    import inspect
    import pb_bss_tpu.evaluation as jax_evaluation
    import pb_bss_tpu.transform as jax_transform
    import pb_bss_tpu_torch.evaluation as evaluation
    import pb_bss_tpu_torch.transform as transform
    for jax_module, module in ((jax_evaluation, evaluation),
                               (jax_transform, transform)):
        names = {n for n in dir(jax_module) if not n.startswith('_')}
        missing = sorted(n for n in names if not hasattr(module, n))
        assert not missing, (module.__name__, missing)
    for name in ('bss_eval_sources_batch', 'bss_eval_sources_device',
                 'mir_eval_sources_batch', 'stoi_batch', 'stoi_device',
                 'srmr_batch', 'srmr_device', 'InputMetrics',
                 'OutputMetrics', 'InputMetricsBatch',
                 'OutputMetricsBatch'):
        default = inspect.signature(getattr(evaluation, name)).parameters[
            'device'].default
        assert default == 'cuda', name
    assert 'method' not in inspect.signature(transform.stft).parameters
    assert {'si_sdr_allow_float32', 'si_sdr_stft'} <= set(dir(evaluation))
