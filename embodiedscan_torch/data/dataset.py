"""EmbodiedScan on-disk dataset: info pkl + VG json -> packed batches (port
of ``embodiedscan_tpu/data/dataset.py``).

Parses the reference's annotation format
(``embodiedscan/datasets/embodiedscan_dataset.py:93-226``):
- per-scan info dicts with ``images`` (img/depth paths, cam2global,
  visible_instance_ids), ``cam2img``/``depth_cam2img``, ``axis_align_matrix``
  and ``instances`` (9-DoF ``bbox_3d`` + ``bbox_label_3d``).
- extrinsic per view = inv(axis_align_matrix @ cam2global).
- depth shift 4000 for matterport3d, 1000 otherwise.
- grounding: VG json entries joined by scan id
  (``datasets/mv_3dvg_dataset.py:220-405``) with text + tokens_positive.

Images load via PIL (imported when a view is loaded); depth PNGs are uint16
millimeter maps. All outputs are the same static-shape packed samples as
the synthetic fixture. The process shard follows ``torch.distributed``'s
rank and world size when a process group is initialized (one process, rank
0, otherwise).
"""

import json
import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..configs.base import Config
from . import pipeline as pl


def process_rank_and_count() -> tuple:
    """(rank, world size) of an initialized ``torch.distributed`` process
    group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def load_info_pkl(path: str):
    with open(path, 'rb') as f:
        data = pickle.load(f)
    if isinstance(data, dict) and 'data_list' in data:
        return data['data_list'], data.get('metainfo', {})
    return data, {}


def occ_ann_paths(sample_idx: str) -> tuple:
    """Occupancy gt + per-view visibility paths for a scan id.

    Mirrors the per-source layout of embodiedscan_dataset.py:200-231:
    scannet/3rscan store occupancy.npy + visible_occupancy.pkl under the
    region dir; matterport3d suffixes the region name; arkitscenes has none.
    """
    parts = sample_idx.split('/')
    ds = parts[0]
    if ds == 'scannet' and len(parts) >= 2:
        base = os.path.join(ds, 'scans', parts[1], 'occupancy')
        return (os.path.join(base, 'occupancy.npy'),
                os.path.join(base, 'visible_occupancy.pkl'))
    if ds == '3rscan' and len(parts) >= 2:
        base = os.path.join(ds, parts[1], 'occupancy')
        return (os.path.join(base, 'occupancy.npy'),
                os.path.join(base, 'visible_occupancy.pkl'))
    if ds == 'matterport3d' and len(parts) >= 3:
        base = os.path.join(ds, parts[1], 'occupancy')
        return (os.path.join(base, f'occupancy_{parts[2]}.npy'),
                os.path.join(base, f'visible_occupancy_{parts[2]}.pkl'))
    return None, None


def parse_scan(info: dict, data_root: str) -> dict:
    """One raw info dict -> scan record (embodiedscan_dataset.py:93-158)."""
    dataset = info['sample_idx'].split('/')[0]
    depth_shift = 4000.0 if dataset == 'matterport3d' else 1000.0
    axis_align = np.asarray(info['axis_align_matrix'], np.float64)
    views = []
    global_k = info.get('cam2img')
    for img in info['images']:
        cam2global = np.asarray(img['cam2global'], np.float64)
        extrinsic = np.linalg.inv(axis_align @ cam2global).astype(np.float32)
        k = img.get('cam2img', global_k)
        depth_k = img.get('depth_cam2img', info.get('depth_cam2img', k))
        views.append(
            dict(img_path=os.path.join(data_root, img['img_path']),
                 depth_path=os.path.join(data_root, img['depth_path']),
                 intrinsic=np.asarray(k, np.float32),
                 depth_intrinsic=np.asarray(depth_k, np.float32),
                 extrinsic=extrinsic,
                 visible_instance_ids=np.asarray(
                     img.get('visible_instance_ids', []), np.int64)))
    boxes = np.zeros((len(info.get('instances', [])), 9), np.float32)
    labels = np.zeros((len(boxes),), np.int64)
    for i, inst in enumerate(info.get('instances', [])):
        boxes[i] = np.asarray(inst['bbox_3d'], np.float32)
        labels[i] = inst['bbox_label_3d']
    occ_path, occ_mask_path = occ_ann_paths(info['sample_idx'])
    return dict(scan_id=info['sample_idx'], views=views,
                depth_shift=depth_shift, gt_boxes=boxes, gt_labels=labels,
                occupancy_path=info.get('occupancy_path', occ_path),
                visible_occupancy_path=info.get('visible_occupancy_path',
                                                occ_mask_path))


def load_occupancy_gt(scan: dict, data_root: str,
                      max_voxels: int) -> tuple:
    """Load sparse occupancy gt (N, 4) xyz+label from npy/pkl.

    The reference stores per-scan occupancy as an (N, 4) array of voxel
    coords + semantic label (LoadAnnotations3D with_occupancy,
    datasets/transforms/loading.py); 0 is empty, labels are 1-based.
    Returns a padded (max_voxels, 4) float array + mask.
    """
    path = scan.get('occupancy_path')
    occ = np.zeros((0, 4), np.float32)
    if path:
        full = os.path.join(data_root, path)
        if full.endswith('.npy') and os.path.exists(full):
            occ = np.load(full).astype(np.float32)
        elif os.path.exists(full):
            with open(full, 'rb') as f:
                occ = np.asarray(pickle.load(f), np.float32)
    n = min(len(occ), max_voxels)
    out = np.zeros((max_voxels, 4), np.float32)
    mask = np.zeros(max_voxels, bool)
    out[:n] = occ[:n]
    mask[:n] = True
    return out, mask


def load_visible_occupancy(scan: dict, data_root: str,
                           view_ids) -> Optional[List[np.ndarray]]:
    """Per-selected-view dense (X, Y, Z) visibility masks, or None.

    The reference stores a per-image list of dicts with a
    ``visible_occupancy`` dense bool grid (embodiedscan_dataset.py:244-252,
    visible_occupancy.pkl); the loss marks voxels outside the mask as 255
    (occ_loss.py:33-34).
    """
    path = scan.get('visible_occupancy_path')
    if not path:
        return None
    full = os.path.join(data_root, path)
    if not os.path.exists(full):
        return None
    with open(full, 'rb') as f:
        per_view = pickle.load(f)
    out = []
    for i in view_ids:
        entry = per_view[int(i)]
        mask = entry['visible_occupancy'] if isinstance(entry, dict) else \
            entry
        out.append(np.asarray(mask, bool))
    return out


def load_view(view: dict, depth_shift: float, image_hw) -> dict:
    """Load RGB + depth for one view, resize RGB, keep scaled intrinsics."""
    from PIL import Image
    h, w = image_hw
    rgb = Image.open(view['img_path']).convert('RGB')
    w0, h0 = rgb.size
    rgb = np.asarray(rgb.resize((w, h)), np.uint8)
    depth = np.asarray(Image.open(view['depth_path']),
                       np.float32) / depth_shift
    # fold the Resize scale factor into the projection intrinsic
    # (point_fusion.py:171-172 img_scale_factor)
    k = view['intrinsic'].copy()
    scale = np.diag([w / w0, h / h0, 1.0]).astype(np.float32)
    pad = np.eye(4, dtype=np.float32)
    kk = np.asarray(k, np.float32)
    pad[:kk.shape[0], :kk.shape[1]] = kk
    pad[:3] = scale @ pad[:3]
    return dict(rgb=rgb, depth=depth, intrinsic=pad,
                depth_intrinsic=view['depth_intrinsic'],
                extrinsic=view['extrinsic'])


class EmbodiedScanLoader:
    """Iterates packed samples from the on-disk dataset."""

    def __init__(self, cfg: Config, train: bool):
        self.cfg = cfg
        self.train = train
        d = cfg.data
        ann = d.ann_file if train else d.val_ann_file
        self.infos, self.metainfo = load_info_pkl(
            os.path.join(d.data_root, ann))
        # eval-report wiring (reference det_metric.py:93-97): categories is
        # a name -> label dict in the info metainfo
        cats = self.metainfo.get('categories') or {}
        self.label2cat = {v: k for k, v in cats.items()} or None
        self.classes_split = self.metainfo.get('classes_split')
        self.batch_size = d.batch_size if train else 1
        if cfg.model.task == 'mv_grounding' and d.vg_file:
            with open(os.path.join(d.data_root, d.vg_file)) as f:
                self.vg = json.load(f)
        else:
            self.vg = None
        # per-process shard (reference DistSamplerSeedHook semantics,
        # configs/default_runtime.py:9): batch_size is PER PROCESS; the
        # global batch is batch_size * process_count
        self.process_index, self.process_count = process_rank_and_count()
        self.steps_per_epoch = max(
            1,
            len(self.infos) * max(1, d.repeat_times)
            // (self.batch_size * self.process_count))

    def _shard(self, idx: np.ndarray) -> np.ndarray:
        """This process's slice of an epoch's index list.

        Train: rank-strided view of the (identically seeded) global
        permutation. Eval: same, but padded by repeating the last index so
        every process runs the SAME number of batches (collective calls
        must not diverge across ranks); rows past ``local_real`` are that
        padding.
        """
        if self.process_count == 1:
            self.local_real = len(idx)
            return idx
        mine = idx[self.process_index::self.process_count]
        self.local_real = len(mine)  # rows past this are padding
        per = -(-len(idx) // self.process_count)
        if len(mine) < per and len(mine) > 0:
            mine = np.concatenate([mine, mine[-1:].repeat(per - len(mine))])
        return mine

    def _build_sample(self, info: dict, seed: int) -> Dict[str, np.ndarray]:
        d = self.cfg.data
        task = self.cfg.model.task
        rng = np.random.RandomState(seed)
        scan = parse_scan(info, d.data_root)
        n_views = d.n_views_train if self.train else d.n_views_test
        ids = pl.select_views(len(scan['views']), n_views,
                              ordered=not self.train, rng=rng)
        depths, dks, exts, ks, imgs, vis_ids = [], [], [], [], [], []
        for i in ids:
            view = load_view(scan['views'][i], scan['depth_shift'],
                             tuple(d.image_hw))
            depths.append(view['depth'])
            dks.append(view['depth_intrinsic'])
            exts.append(view['extrinsic'])
            ks.append(view['intrinsic'])
            imgs.append(pl.normalize_imgs(view['rgb'][None],
                                          bgr_to_rgb=False)[0])
            vis_ids.append(scan['views'][i]['visible_instance_ids'])
        # fused back-project + sample + ego->global (threaded C++ when the
        # native core is available; cfg.data.native_pipeline)
        view_pts = pl.multiview_world_points(depths, dks, exts,
                                             d.points_per_view, rng,
                                             native=d.native_pipeline)
        boxes, labels = scan['gt_boxes'], scan['gt_labels']

        occ_task = task in ('mv_occ', 'cont_occ')
        if occ_task:
            # PointsRangeFilter before voxelization (occ configs, reference
            # points.py:226); per-view filtering == the reference's
            # aggregated filter, and keeps sweep slice boundaries intact
            pcr = tuple(self.cfg.model.point_cloud_range)
            filtered = [pl.points_range_filter(p, pcr) for p in view_pts]
            if sum(len(p) for p in filtered) >= 100:
                view_pts = filtered

        aug = None
        if self.train:
            sizes = np.cumsum([len(p) for p in view_pts])[:-1]
            points = np.concatenate(view_pts)
            if task in ('mv_det3d', 'cont_det3d'):
                points, boxes, fmat = pl.random_flip(points, boxes, rng)
            else:
                fmat = np.eye(4, dtype=np.float32)
            points, boxes, rmat = pl.global_rot_scale_trans(
                points, boxes, rng)
            aug = rmat @ fmat
            view_pts = np.split(points, sizes)

        if task in ('cont_det3d', 'cont_occ'):
            occ_vis = load_visible_occupancy(scan, d.data_root, ids) \
                if occ_task else None
            sample = pl.pack_sweeps(view_pts, vis_ids, np.stack(imgs), ks,
                                    exts, boxes, labels, aug, d.n_points,
                                    d.max_boxes, rng, occ_visible=occ_vis)
            v = sample['points'].shape[0]
            if occ_task:
                occ, occ_mask = load_occupancy_gt(scan, d.data_root,
                                                  d.max_occ_voxels)
                sample['gt_occ'] = np.tile(occ[None], (v, 1, 1))
                sample['gt_occ_mask'] = np.tile(occ_mask[None], (v, 1))
            return sample

        sample = pl.pack_sample(np.concatenate(view_pts), np.stack(imgs), ks,
                                exts, boxes, labels, aug, d.n_points,
                                d.max_boxes, rng)
        if occ_task:
            occ, occ_mask = load_occupancy_gt(scan, d.data_root,
                                              d.max_occ_voxels)
            sample['gt_occ'] = occ
            sample['gt_occ_mask'] = occ_mask
            occ_vis = load_visible_occupancy(scan, d.data_root, ids)
            if occ_vis is not None:
                # ConstructMultiViewMasks: one cumulative mask over the
                # selected views (multiview.py:250-273; the reference's loop
                # skips the last view — an apparent off-by-one we do not
                # reproduce)
                m = occ_vis[0].astype(bool)
                for vm in occ_vis[1:]:
                    m = m | vm.astype(bool)
                sample['visible_mask'] = m
        return sample

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.infos))
        rng = np.random.RandomState(self.cfg.seed)
        epoch_len = len(order) * max(1, self.cfg.data.repeat_times)
        while True:
            if self.train:
                idx = rng.permutation(epoch_len) % len(order)
            else:
                idx = order
            idx = self._shard(np.asarray(idx))
            collate = pl.collate_sweeps if self.cfg.model.task in (
                'cont_det3d', 'cont_occ') else pl.collate
            for start in range(0, len(idx) - self.batch_size + 1,
                               self.batch_size):
                chunk = idx[start:start + self.batch_size]
                # seeds drawn sequentially BEFORE dispatch: determinism is
                # independent of worker scheduling
                seeds = [int(rng.randint(1 << 30)) for _ in chunk]
                samples = self._map_workers(
                    lambda a: self._build_sample(self.infos[a[0]], a[1]),
                    list(zip(chunk, seeds)))
                yield collate(samples)
            if not self.train:
                return

    def _map_workers(self, fn, items: list) -> list:
        """Build a batch's samples on cfg.data.num_workers threads (PIL,
        numpy, and the native core release the GIL; the reference uses 4
        DataLoader workers per GPU — mv-det3d...py:182)."""
        workers = min(self.cfg.data.num_workers, len(items))
        if workers <= 1 or len(items) <= 1:
            return [fn(it) for it in items]
        from concurrent.futures import ThreadPoolExecutor
        if getattr(self, '_pool', None) is None or \
                self._pool._max_workers != workers:
            self._pool = ThreadPoolExecutor(max_workers=workers)
        return list(self._pool.map(fn, items))


VIEW_DEP_WORDS = ('front', 'behind', 'back', 'left', 'right', 'facing',
                  'leftmost', 'rightmost', 'looking', 'across')


def is_view_dep(text: str) -> bool:
    """sr3d view-dependence heuristic (mv_3dvg_dataset.py:221-228)."""
    words = set(text.split())
    return any(w in words for w in VIEW_DEP_WORDS)


def join_vg_annotations(infos: List[dict], vg_entries: List[dict],
                        tokens_positive_rebuild: bool = True) -> List[dict]:
    """Join VG language annotations with scan infos
    (mv_3dvg_dataset.py:287-405).

    Returns per-prompt records: scan info index, text, target box rows,
    tokens_positive char spans, and the Easy/Hard/View-Dep/Unique flags.
    """
    by_id = {info['sample_idx']: i for i, info in enumerate(infos)}
    out = []
    for anno in vg_entries:
        sid = anno.get('scan_id')
        if sid not in by_id:
            continue
        info = infos[by_id[sid]]
        instances = info.get('instances', [])
        # bbox_id: explicit per-instance id when present, else position
        obj_ids = np.asarray([
            inst.get('bbox_id', i) for i, inst in enumerate(instances)
        ])
        rec = dict(info_idx=by_id[sid], text=anno['text'],
                   is_view_dep=is_view_dep(anno['text']),
                   is_hard=len(anno.get('distractor_ids', [])) > 3,
                   is_unique=len(anno.get('distractor_ids', [])) == 0)
        target_id = anno.get('target_id')
        if target_id is None:
            rec['target_rows'] = list(range(len(instances)))
            rec['tokens_positive'] = []
            out.append(rec)
            continue
        targets = [target_id] if isinstance(target_id, int) else target_id
        rows = []
        ok = True
        for tid in targets:
            ind = np.where(obj_ids == tid)[0]
            if len(ind) != 1:
                ok = False
                break
            rows.append(int(ind[0]))
        if not ok:
            continue
        rec['target_rows'] = rows
        if tokens_positive_rebuild and 'target' in anno:
            spans = [[anno['text'].find(part),
                      anno['text'].find(part) + len(part)]
                     for part in anno['target'].split()
                     if anno['text'].find(part) >= 0]
            rec['tokens_positive'] = [spans] * len(rows) if isinstance(
                target_id, int) else [[s] for s in spans][:len(rows)]
        elif 'tokens_positive' in anno:
            tp = anno['tokens_positive']
            rec['tokens_positive'] = [tp] if isinstance(target_id, int) \
                else [[tp[i]] for i in range(len(rows))]
        else:
            rec['tokens_positive'] = [[] for _ in rows]
        out.append(rec)
    return out


class GroundingLoader(EmbodiedScanLoader):
    """Per-prompt batches for visual grounding (MultiView3DGroundingDataset)."""

    def __init__(self, cfg: Config, train: bool):
        super().__init__(cfg, train)
        if self.vg is None:
            with open(os.path.join(cfg.data.data_root,
                                   cfg.data.vg_file)) as f:
                self.vg = json.load(f)
        self.records = join_vg_annotations(self.infos, self.vg)
        from ..models.text import get_tokenizer
        self.tokenizer = get_tokenizer(cfg.data.tokenizer_path,
                                       max_len=cfg.model.max_text_len)
        self.steps_per_epoch = max(
            1,
            len(self.records) // (self.batch_size * self.process_count))

    def _build_vg_sample(self, rec: dict, seed: int):
        from ..models.text import build_positive_maps
        sample = self._build_sample(self.infos[rec['info_idx']], seed)
        # narrow gt to the prompt's target boxes
        d = self.cfg.data
        rows = rec['target_rows'][:d.max_boxes]
        g = len(rows)
        boxes = sample['gt_boxes'].copy()
        labels = sample['gt_labels'].copy()
        gmask = np.zeros_like(sample['gt_mask'])
        boxes[:g] = sample['gt_boxes'][rows]
        labels[:g] = sample['gt_labels'][rows]
        gmask[:g] = True
        sample['gt_boxes'], sample['gt_labels'] = boxes, labels
        sample['gt_mask'] = gmask
        enc = self.tokenizer([rec['text']])
        maps = build_positive_maps(self.tokenizer, [rec['text']],
                                   [rec['tokens_positive']],
                                   self.cfg.model.max_text_len, d.max_boxes)
        sample['text_ids'] = enc['input_ids'][0]
        sample['text_mask'] = enc['attention_mask'][0]
        sample['positive_maps'] = maps[0]
        sample['is_view_dep'] = np.bool_(rec['is_view_dep'])
        sample['is_hard'] = np.bool_(rec['is_hard'])
        sample['is_unique'] = np.bool_(rec['is_unique'])
        return sample

    def __iter__(self):
        rng = np.random.RandomState(self.cfg.seed)
        order = np.arange(len(self.records))
        while True:
            idx = rng.permutation(order) if self.train else order
            idx = self._shard(np.asarray(idx))
            for start in range(0, len(idx) - self.batch_size + 1,
                               self.batch_size):
                chunk = idx[start:start + self.batch_size]
                seeds = [int(rng.randint(1 << 30)) for _ in chunk]
                samples = self._map_workers(
                    lambda a: self._build_vg_sample(self.records[a[0]],
                                                    a[1]),
                    list(zip(chunk, seeds)))
                yield pl.collate(samples)
            if not self.train:
                return
