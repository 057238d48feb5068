"""Batch loaders: synthetic fixture or on-disk EmbodiedScan data (port of
``embodiedscan_tpu/data/loader.py``), and the move of a batch to the card.

A loader is a plain-python iterable of collated numpy batches with static
shapes; :func:`to_device` moves one to a device. :class:`Prefetcher`
overlaps the host pipeline with the device step (the reference's
``num_workers=4, persistent_workers=True`` DataLoader,
configs/detection/mv-det3d...py:182-183): a producer thread runs the loader
ahead into a bounded queue (JPEG decode, resize, back-projection and
packing release the interpreter lock in PIL, numpy and the native core).
"""

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import Config
from ..utils.trace import span
from . import pipeline as pl

CONT_TASKS = ('cont_det3d', 'cont_occ')


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``. To a CUDA device
    each array goes through page-locked host memory and an asynchronous
    copy on the current stream (work queued after it on that stream sees
    the data); to the CPU the tensors share the arrays' memory."""
    device = torch.device(device)
    out = {}
    with span('es.to_device'):
        for key, val in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(val))
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
    return out


class Prefetcher:
    """Background-thread prefetch over any batch iterable.

    ``depth`` bounds the queue (memory = depth x batch bytes). Attribute
    access proxies to the inner loader (steps_per_epoch, label2cat, ...).
    Exceptions in the producer re-raise in the consumer; a finished inner
    iterator ends this iterator (eval single-pass semantics preserved).
    """

    _DONE = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list = []

        def produce():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(self._DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._DONE:
                if err:
                    raise err[0]
                return
            yield item


class SyntheticLoader:
    """Synthetic multi-view scans for smoke training and tests. A train
    loader draws its batches from ``seed`` (default: fresh entropy each
    pass), an eval loader from 0."""

    def __init__(self, cfg: Config, train: bool, n_scans: int = 8,
                 seed: int | None = None):
        self.cfg = cfg
        self.train = train
        self.n_scans = n_scans
        self.seed = seed if train else 0
        d = cfg.data
        self.batch_size = d.batch_size if train else 1
        self.steps_per_epoch = max(1, n_scans // self.batch_size)
        from .synthetic import make_scan
        views = max(d.n_views_train, 4)
        # g == max_boxes: every packed GT slot is a real object and every
        # box point cluster in the cloud has a GT (no ghost distractors)
        self._scans = [
            make_scan(seed=i, n_views=views, hw=(64, 64),
                      g=min(d.max_boxes, 16),
                      num_classes=cfg.model.num_classes)
            for i in range(n_scans)
        ]

    def _synthetic_occ(self, seed, m=256):
        rng = np.random.RandomState(seed)
        nx, ny, nz = self.cfg.model.n_voxels
        occ = np.concatenate([
            rng.randint(0, nx, (m, 1)),
            rng.randint(0, ny, (m, 1)),
            rng.randint(0, nz, (m, 1)),
            rng.randint(1, self.cfg.model.occ_classes, (m, 1))
        ], -1).astype(np.float32)
        return occ, np.ones(m, bool)

    def _sample(self, scan, seed):
        from .synthetic import scan_to_batch, scan_to_sweeps
        d = self.cfg.data
        task = self.cfg.model.task
        n_views = d.n_views_train if self.train else \
            min(d.n_views_test, len(scan['views']))
        if task in CONT_TASKS:
            # continuous pseudo-batch: 1..V cumulative sweeps sharing one
            # image set (ConstructMultiSweeps + embodied_det3d.py:109-160)
            occ_shape = tuple(self.cfg.model.n_voxels) \
                if task == 'cont_occ' else None
            sample = scan_to_sweeps(
                scan, n_views=n_views, num_points=d.n_points,
                num_boxes=d.max_boxes, seed=seed, train=self.train,
                points_per_view=d.points_per_view, occ_shape=occ_shape)
            if task == 'cont_occ':
                occ, occ_mask = self._synthetic_occ(seed)
                v = sample['points'].shape[0]
                sample['gt_occ'] = np.tile(occ[None], (v, 1, 1))
                sample['gt_occ_mask'] = np.tile(occ_mask[None], (v, 1))
            return sample
        sample = scan_to_batch(
            scan, n_views=n_views,
            num_points=d.n_points, num_boxes=d.max_boxes, seed=seed,
            train=self.train, points_per_view=d.points_per_view)
        if task == 'mv_occ':
            occ, occ_mask = self._synthetic_occ(seed)
            sample['gt_occ'] = occ
            sample['gt_occ_mask'] = occ_mask
            rng = np.random.RandomState(seed + 2)
            sample['visible_mask'] = \
                rng.rand(*self.cfg.model.n_voxels) > 0.2
        if task == 'mv_grounding':
            from ..models.text import SimpleTokenizer, build_positive_maps
            tok = SimpleTokenizer(max_len=self.cfg.model.max_text_len)
            text = 'find the object near the wall'
            enc = tok([text])
            g = self.cfg.data.max_boxes
            maps = build_positive_maps(tok, [text], [[[[9, 15]]]],
                                       self.cfg.model.max_text_len, g)
            sample['text_ids'] = enc['input_ids'][0]
            sample['text_mask'] = enc['attention_mask'][0]
            sample['positive_maps'] = maps[0]
            # deterministic pseudo flags so the eval bucket paths
            # (Easy/Hard/View-Dep/Unique) are exercised on synthetic data
            sample['is_view_dep'] = np.bool_(seed % 3 == 0)
            sample['is_hard'] = np.bool_(seed % 2 == 0)
            sample['is_unique'] = np.bool_(seed % 5 == 0)
        return sample

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        collate = pl.collate_sweeps if self.cfg.model.task in CONT_TASKS \
            else pl.collate
        while True:
            idx = rng.randint(0, self.n_scans, self.batch_size)
            samples = [
                self._sample(self._scans[i], int(rng.randint(1 << 30)))
                for i in idx
            ]
            yield collate(samples)
            if not self.train:
                # single pass over scans for eval
                self._eval_count = getattr(self, '_eval_count', 0) + 1
                if self._eval_count >= self.n_scans:
                    self._eval_count = 0
                    return


def build_loader(cfg: Config, train: bool):
    """The task's loader: synthetic scans (``cfg.data.synthetic``), per-prompt
    grounding batches (an ``mv_grounding`` task with a ``vg_file``) or the
    on-disk scans, the last two behind a :class:`Prefetcher` when
    ``cfg.data.prefetch_depth`` > 0."""
    if cfg.data.synthetic:
        return SyntheticLoader(cfg, train)  # in-memory, nothing to overlap
    if cfg.model.task == 'mv_grounding' and cfg.data.vg_file:
        from .dataset import GroundingLoader
        loader = GroundingLoader(cfg, train)
    else:
        from .dataset import EmbodiedScanLoader
        loader = EmbodiedScanLoader(cfg, train)
    if cfg.data.prefetch_depth > 0:
        return Prefetcher(loader, depth=cfg.data.prefetch_depth)
    return loader
