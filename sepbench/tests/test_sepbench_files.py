"""Every file a cell is found by loads, and every name keeps to the
contract's characters."""
from __future__ import annotations

import json
import math
import re

import pytest

from small import ROOT
from sepbench.harness import runner

BENCHMARK = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRICS = BENCHMARK['end_to_end'] + BENCHMARK['per_layer']


def test_top_level_keys():
    assert set(BENCHMARK) == {'command', 'paths', 'run_seconds', 'configs',
                              'workloads', 'end_to_end', 'per_layer'}
    assert BENCHMARK['paths'] == ['sepbench']
    assert BENCHMARK['command'] == ['python3', 'sepbench/run.py']
    assert 1 <= BENCHMARK['run_seconds'] <= 51


@pytest.mark.parametrize('config', BENCHMARK['configs'],
                         ids=lambda c: c['name'])
def test_configuration_files(config):
    assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    assert config['file'].startswith('sepbench/configs/')
    data = json.loads((ROOT / config['file']).read_text())
    assert data['name'] == config['name']
    assert data['reduced'] == config['reduced']
    assert data['assumed']
    assert any(w['config'] == config['name']
               for w in BENCHMARK['workloads'])


@pytest.mark.parametrize('workload', BENCHMARK['workloads'],
                         ids=lambda w: w['name'])
def test_cell_files(workload):
    assert set(workload) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert workload['chips'] == 1
    cell = runner.Cell(workload['name'])
    assert cell.spec['driver']
    assert cell.spec['limits'] and all(
        0 <= limit < math.inf for limit in cell.spec['limits'].values())
    for layer in cell.layers.values():
        assert layer['targets']
    runner.load_module('drivers', cell.spec['driver'])
    assert cell.traffic['batch'] >= 1 and cell.traffic['pool_batches'] >= 2
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric_files(metric):
    reader = runner.load_module('metrics', metric['name'])
    assert callable(reader.read)
    assert metric['better'] in ('lower', 'higher')
    assert UNIT.match(metric['unit'])
    workloads = {w['name'] for w in BENCHMARK['workloads']}
    assert set(metric.get('workloads', workloads)) <= workloads
    if metric in BENCHMARK['per_layer']:
        assert metric['moves'] in {m['name'] for m in
                                   BENCHMARK['end_to_end']}
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
        assert metric['layer'] and '\n' not in metric['layer']
    else:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25


def test_names():
    names = [m['name'] for m in METRICS] \
        + [c['name'] for c in BENCHMARK['configs']] \
        + [w['name'] for w in BENCHMARK['workloads']] \
        + [w['traffic'] for w in BENCHMARK['workloads']] \
        + [key for c in BENCHMARK['configs'] for key in c['reduced']]
    assert all(NAME.match(n) for n in names), names
    for group in (METRICS, BENCHMARK['configs'], BENCHMARK['workloads']):
        assert len({x['name'] for x in group}) == len(group)
    pairs = [(w['config'], w['traffic']) for w in BENCHMARK['workloads']]
    assert len(set(pairs)) == len(pairs)
    for text in [w['why'] for w in BENCHMARK['workloads']] \
            + [c['why'] for c in BENCHMARK['configs']]:
        assert 1 <= len(text) <= 200 and '\n' not in text


def test_harness_names_no_cell_configuration_or_metric():
    names = {m['name'] for m in METRICS} \
        | {c['name'] for c in BENCHMARK['configs']} \
        | {w['name'] for w in BENCHMARK['workloads']}
    for path in [ROOT / 'sepbench' / 'run.py',
                 *(ROOT / 'sepbench' / 'harness').glob('*.py')]:
        text = path.read_text()
        found = [n for n in names if re.search(
            rf"['\"]{re.escape(n)}['\"]", text)]
        assert not found, (path, found)
