"""The port's examples (examples/*_torch.py) run end to end on the CPU
(``device='cpu'``) at the JAX example tests' sizes
(tests/test_example.py) and print the JAX examples' lines; the
integration example meets the JAX test's floor (accuracy > 0.8 for both
models). Their imports hold neither jax nor pb_bss_tpu."""
import ast
import importlib
import pathlib
import sys

import pytest
import torch

torch.set_num_threads(2)

EXAMPLES = pathlib.Path(__file__).parent.parent / 'examples'
NAMES = ('mixture_model_example_torch', 'integration_model_example_torch',
         'evaluation_example_torch', 'streaming_example_torch')


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.mark.parametrize('name', NAMES)
def test_example_imports_no_jax(name):
    tree = ast.parse((EXAMPLES / f'{name}.py').read_text())
    modules = [alias.name for node in ast.walk(tree)
               if isinstance(node, ast.Import) for alias in node.names]
    modules += [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)]
    roots = {m.split('.')[0] for m in modules}
    assert 'jax' not in roots and 'pb_bss_tpu' not in roots, roots
    assert 'pb_bss_tpu_torch' in roots, roots


def test_mixture_model_example_runs(capsys):
    _example('mixture_model_example_torch').main(
        reverb=False, iterations=3, device='cpu')
    out = capsys.readouterr().out
    assert 'mask-based extraction' in out
    assert 'GEV+BAN beamforming' in out
    assert 'unprocessed observation' in out


def test_integration_model_example_runs(capsys):
    _example('integration_model_example_torch').main(device='cpu')
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(':')[0] for line in lines] == [
        'VMFCACGMM', 'GCACGMM (spherical)']
    # both integration models must clearly beat chance
    for line in lines:
        acc = float(line.split('accuracy')[1].split('(')[0])
        assert acc > 0.8, line


def test_evaluation_example_runs(capsys):
    _example('evaluation_example_torch').main(iterations=3, batch=2,
                                              device='cpu')
    out = capsys.readouterr().out
    assert 'separated: (2, 3, ' in out
    assert 'SDR gain' in out
    assert 'STOI' in out
    assert 'SRMR' in out
    assert 'utterance 0 via OutputMetrics' in out


def test_streaming_example_runs(capsys):
    """The masks sum to one: the summed outputs reconstruct the delayed
    reference channel (to 1e-4 of f32 rounding, measured 1.9e-6)."""
    _example('streaming_example_torch').main(device='cpu')
    out = capsys.readouterr().out
    error = float(out.split('reconstruction error:')[1].split()[0])
    assert error < 1e-4, out
    assert out.count('best stream output') == 2, out
