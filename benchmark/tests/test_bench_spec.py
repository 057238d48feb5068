"""BENCHMARK.json against the contract's character rules, and every name
in it found as a file."""

import json
import re

from benchmark.harness import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
END = {'train_scenes_per_s', 'latency_p50_ms', 'latency_p90_ms', 'peak_gib',
       'setup_s'}


def test_names_and_units():
    b = spec.benchmark()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    names = []
    for c in b['configs']:
        assert NAME.match(c['name']) and TEXT.match(c['source'])
        assert all(NAME.match(k) for k in c['reduced'])
        names.append(c['name'])
    for w in b['workloads']:
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] == 1 and TEXT.match(w['why'])
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in b['per_layer']:
        assert TEXT.match(m['layer'])
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
    assert {m['name'] for m in b['end_to_end']} == END
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    assert 10 <= b['run_seconds'] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_has_its_files():
    b = spec.benchmark()
    for w in b['workloads']:
        c = spec.cell(w['name'], b)
        assert c['work']['mode'] in ('train', 'serve')
        assert c['end_to_end'] and c['per_layer']
        assert any(m['name'] == 'setup_s' for m in c['end_to_end'])
        assert c['conf']['reduced'] == []
    for m in b['per_layer']:
        assert callable(spec.metric_reader(m['name']))


def test_per_layer_only_where_their_metric_is():
    b = spec.benchmark()
    ends = {m['name']: set(m.get('workloads', [w['name'] for w in
                                                b['workloads']]))
            for m in b['end_to_end']}
    for m in b['per_layer']:
        assert set(m['workloads']) <= ends[m['moves']], m['name']
