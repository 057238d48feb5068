"""Port vs reference: the occupancy-histogram and overfit tools
(``embodiedscan_torch/tools/{occupancy_histogram,quality_smoke}.py``
against the reference package's ``tools/`` and ``tests/test_quality.py``).

- ``chain_counts`` gives the reference tool's counts, integers identical,
  on a seeded cloud at a small size, with capacities that truncate some
  levels (an overflow drops the largest keys on both sides); ``measure``
  (the measuring capacities) gives the reference chain's counts where
  nothing is cut, and raises where a level fills its capacity;
- ``bench_points`` equals ``bench.make_batch``'s points bit for bit;
- ``tiny_cfg`` equals the reference's, field for field, for each task;
- ``quality_smoke --steps 3 --device cpu --out <tmp>`` writes its three
  sections and passes its gate, with the occupancy model's U-Net cut to a
  32-channel input (``occ_pre_neck_channels``) so that its 40 steps take
  seconds on the CPU.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodiedscan_torch.tools import occupancy_histogram as tH
from embodiedscan_torch.tools import quality_smoke as tQ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'reference_{name}', os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('caps', [(4096, 2048, 2048, 1024, 512, 256, 128),
                                  (1024, 512, 256, 128, 64, 32, 16)])
def test_chain_counts_match_the_reference(caps):
    ref = _reference_tool('occupancy_histogram')
    pts = tH.bench_points(2, 3000, seed=3)
    pts[1, :500] += 0.5  # the two samples differ
    mask = np.ones((2, 3000), bool)
    mask[0, ::7] = False
    want = ref.chain_counts(jnp.asarray(pts), jnp.asarray(mask), 0.02,
                            list(caps))
    got = tH.chain_counts(torch.from_numpy(pts), torch.from_numpy(mask),
                          0.02, caps)
    assert got == want
    assert len(got) == 7 and got[0] > got[-1] > 0


def test_measure_counts_every_voxel(monkeypatch):
    """At the measuring capacities no level is cut: the reference's chain
    with room for every point at every level gives the same counts; a
    level that fills its capacity, or an input that could, raises."""
    ref = _reference_tool('occupancy_histogram')
    pts = tH.bench_points(2, 3000, seed=3)
    mask = np.ones((2, 3000), bool)
    got = tH.measure(torch.from_numpy(pts), torch.from_numpy(mask), 0.02)
    assert got == ref.chain_counts(jnp.asarray(pts), jnp.asarray(mask), 0.02,
                                   [4096] * 7)
    monkeypatch.setattr(tH, 'MEASURE_CAPS', (4096,) * 3 + (got[3],) +
                        (4096,) * 3)
    with pytest.raises(RuntimeError, match='s8'):
        tH.measure(torch.from_numpy(pts), torch.from_numpy(mask), 0.02)
    monkeypatch.setattr(tH, 'MEASURE_CAPS', (3000,) * 7)
    with pytest.raises(ValueError):
        tH.measure(torch.from_numpy(pts), torch.from_numpy(mask), 0.02)


def test_suggest_matches_the_reference():
    ref = _reference_tool('occupancy_histogram')
    for count in (0, 1, 2047, 2048, 2049, 30247, 98556):
        for margin in (1.0, 1.25):
            assert tH.suggest(count, margin) == ref.suggest(count, margin)


def test_bench_points_are_the_benchmarks():
    import bench
    want = bench.make_batch(2, 5000, 2, 32, 4, 5)['points']
    np.testing.assert_array_equal(tH.bench_points(2, 5000), np.asarray(want))


def _fields(cfg):
    return {sec: dataclasses.asdict(getattr(cfg, sec))
            for sec in ('model', 'data', 'schedule')}


def _plain(v):
    return list(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize('task', ['mv_det3d', 'mv_grounding', 'mv_occ'])
def test_tiny_cfg_matches_the_reference(task):
    from test_quality import tiny_cfg
    want, got = _fields(tiny_cfg(task)), _fields(tQ.tiny_cfg(task))
    for sec in want:
        assert set(want[sec]) <= set(got[sec])
        for key in set(want[sec]) - {'remat'}:
            assert _plain(got[sec][key]) == _plain(want[sec][key]), (sec,
                                                                     key)
    # the one value that differs: the reference's presets' remat '2d', the
    # port's 'none' (the 80 GB card needs no recomputation)
    assert (want['model']['remat'], got['model']['remat']) == ('2d', 'none')
    # a field the reference lacks: its text encoder's 30522 rows
    assert got['model']['text_vocab_size'] == 30522


def test_quality_smoke_writes_its_report(tmp_path, monkeypatch):
    tiny = tQ.tiny_cfg

    def small(task):
        cfg = tiny(task)
        if task == 'mv_occ':
            cfg.model.occ_pre_neck_channels = 32
        return cfg

    monkeypatch.setattr(tQ, 'tiny_cfg', small)
    out = tmp_path / 'quality.md'
    report = tQ.main(['--steps', '3', '--device', 'cpu', '--out', str(out)])
    text = out.read_text()
    assert [ln for ln in text.splitlines() if ln.startswith('## ')] == [
        '## mv_det3d (3 steps)', '## mv_grounding (2 steps)',
        '## mv_occ (40 steps)']
    assert set(report) == {'mv_det3d', 'mv_grounding', 'mv_occ'}
    for task, r in report.items():
        assert r['passed'] and len(r['losses']) == r['steps']
        assert np.isfinite(r['losses']).all()
    assert 'mAP_0.25' in report['mv_det3d']['metrics']
    assert 'Overall@0.25' in report['mv_grounding']['metrics']
    assert 'mIoU' in report['mv_occ']['metrics']


def test_gate_and_windows():
    assert tQ.learned([5.0, 4.0, 3.0])
    assert not tQ.learned([3.0, 4.0, 5.0])
    assert not tQ.learned([5.0, float('nan'), 3.0])
    assert tQ.windows(list(range(20, 0, -1))) == (18.0, 3.0)


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip('checks the CPU-only behavior of the entry points')
    for tool in (tH, tQ):
        with pytest.raises(RuntimeError):
            tool.main([])
