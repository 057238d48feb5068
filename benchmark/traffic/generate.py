"""The benchmark's one traffic generator: synthetic scenes made on a device
from a seed, as a traffic file's parameters ask.

A traffic file (``traffic/<name>.json``) names a ``scene`` kind and its
sizes. Each kind is a file of its own, ``traffic/scenes/<scene>.py``, whose
``make(t, conf, g, device)`` draws one scene of the traffic ``t`` for the
configuration ``conf`` from the generator ``g``: a dict of tensors, the same
keys and sizes for every scene of a traffic file.

Every scene of a pool has its own stream (``spec.sub_seed(seed, 'scene',
i)``), so the same seed gives the same scenes in any order. ``batch``
scenes make one batch; ``pool`` batches are made and cycled.
"""

import math
from pathlib import Path

import torch

from ..harness.spec import BENCH_DIR, load_file, sub_seed


def _gen(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def scene(t: dict, conf: dict, seed: int, index: int, device,
          bench_dir: Path = BENCH_DIR) -> dict:
    """Scene ``index`` of the traffic ``t`` under ``seed``, made by
    ``traffic/scenes/<t['scene']>.py`` of ``bench_dir``."""
    g = _gen(device, sub_seed(seed, 'scene', index))
    path = bench_dir / 'traffic' / 'scenes' / f'{t["scene"]}.py'
    return load_file('scene', path).make(t, conf, g, device)


def batch(t: dict, conf: dict, seed: int, index: int, device,
          bench_dir: Path = BENCH_DIR) -> dict:
    """Batch ``index``: scenes ``index * batch ... + batch - 1`` stacked."""
    b = t['batch']
    scenes = [scene(t, conf, seed, index * b + j, device, bench_dir)
              for j in range(b)]
    return {k: torch.stack([s[k] for s in scenes]) for k in scenes[0]}


def pool(t: dict, conf: dict, seed: int, device,
         bench_dir: Path = BENCH_DIR) -> list:
    return [batch(t, conf, seed, i, device, bench_dir)
            for i in range(t['pool'])]


def arrivals(t: dict, seconds: float) -> list:
    """Due times (s from the window's start) of the requests of an open
    loop at ``rate_per_s``, evenly spaced, that fall inside the window."""
    n = math.ceil(seconds * t['rate_per_s'])
    return [i / t['rate_per_s'] for i in range(n)]
