"""A copy of the benchmark's data files at sizes the CPU can run, for the
tests: the same configurations, cells and metrics with small capacities,
depths and scenes."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = dict(
    mv_det3d=dict(num_classes=5, voxel_size=0.02, input_capacity=1024,
                  backbone_capacities=[1024, 512, 512, 256, 128, 64],
                  fpn_capacities=[256, 128, 64, 32], max_dets=16, nms_pre=32,
                  max_candidates=32, resnet_depth=18, mink_depth=18),
    # the port's own CPU parity size (chip_smoke.py:_occ_parity_cfg)
    mv_occ=dict(input_capacity=8192,
                backbone_capacities=[8192, 8192, 4096, 2048, 1024, 1024],
                occ_pre_neck_channels=32))
TINY_TRAFFIC = dict(points=4000, views=2, image_hw=64, gt_boxes=32,
                    gt_voxels=256)
# the small detector's head sees features far smaller than the full one's:
# its served projections are drawn wider, so that its scores too spread
# above the threshold
TINY_INIT = {'mv_det3d.serve.v50': {'bbox_head.conv_cls.weight': 2.0,
                                    'bbox_head.conv_center.weight': 2.0}}


def tiny_root(tmp: Path) -> Path:
    """A checkout-like directory under ``tmp``: ``BENCHMARK.json`` and the
    benchmark's data files, the models and scenes made small."""
    root = tmp / 'checkout'
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'out'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for path in (root / 'benchmark' / 'configs').glob('*.json'):
        conf = json.loads(path.read_text())
        conf['model'].update(TINY_MODEL[conf['model']['task']])
        path.write_text(json.dumps(conf))
    for cell, init in TINY_INIT.items():
        path = root / 'benchmark' / 'workloads' / f'{cell}.json'
        work = json.loads(path.read_text())
        work['init'] = init
        path.write_text(json.dumps(work))
    for path in (root / 'benchmark' / 'traffic').glob('*.json'):
        t = json.loads(path.read_text())
        for key, val in TINY_TRAFFIC.items():
            if key in t:
                t[key] = val
        t['batch'] = min(t['batch'], 2)
        t['pool'] = max(t['pool'], 3)
        path.write_text(json.dumps(t))
    return root
