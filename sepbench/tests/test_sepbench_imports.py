"""Nothing under sepbench imports JAX or the JAX package, and the
reference imports nothing of the system under test (top-level module
names compared whole: the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast

import pytest

from small import ROOT

BENCH = ROOT / 'sepbench'
FILES = sorted(BENCH.rglob('*.py'))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split('.')[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                'import_module', '__import__') and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    names = set(imported(path))
    assert not names & {'jax', 'jaxlib', 'flax', 'pb_bss_tpu'}, names


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').rglob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert 'pb_bss_tpu_torch' not in names and 'sepbench' not in names, names
    assert names <= {'__future__', 'itertools', 'math', 'numpy', 'scipy',
                     'torch'}, names


def test_names_are_compared_whole(tmp_path, monkeypatch):
    source = tmp_path / 'probe.py'
    source.write_text('import pb_bss_tpu_torch.ops\nfrom jax import numpy\n')
    assert set(imported(source)) == {'pb_bss_tpu_torch', 'jax'}
    import sys
    import types
    from sepbench.harness import runner
    monkeypatch.setitem(sys.modules, 'pb_bss_tpu_torch_probe',
                        types.ModuleType('pb_bss_tpu_torch_probe'))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'pb_bss_tpu.probe',
                        types.ModuleType('pb_bss_tpu.probe'))
    assert runner.forbidden_modules() == ['pb_bss_tpu']
