"""Configs, their ``a.b=c`` overrides and the model entry point (port of
``embodiedscan_tpu/configs/base.py``: the seven presets, the model and
data fields the port reads).
"""

import dataclasses
from typing import Any, Sequence

import torch


def _convert(value: str, current: Any):
    if isinstance(current, bool):
        return value.lower() in ('1', 'true', 'yes')
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        parts = [p for p in value.strip('[]()').split(',') if p]
        elem = current[0] if len(current) else 0
        return type(current)(_convert(p, elem) for p in parts)
    return value


def apply_overrides(cfg: Any, overrides: Sequence[str]):
    """Apply ``a.b=c`` overrides to a (nested) dataclass in place, each
    value parsed as the type of the field's current value."""
    for item in overrides:
        key, _, value = item.partition('=')
        parts = key.split('.')
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], _convert(value, getattr(obj, parts[-1])))
    return cfg


@dataclasses.dataclass
class DataConfig:
    """The data path's settings: the reference package's fields, names and
    defaults, so its ``data.x=y`` overrides apply unchanged."""
    data_root: str = 'data'
    ann_file: str = 'embodiedscan_infos_train.pkl'
    val_ann_file: str = 'embodiedscan_infos_val.pkl'
    vg_file: str = ''
    batch_size: int = 4
    n_views_train: int = 20
    n_views_test: int = 50
    n_points: int = 100000
    points_per_view: int = 10000
    image_hw: Sequence[int] = (480, 480)
    max_boxes: int = 200
    # padded sparse occupancy ground truth (xyz + label) per training scene
    max_occ_voxels: int = 16384
    repeat_times: int = 1
    synthetic: bool = False  # the synthetic fixture instead of disk data
    # directory of RoBERTa's vocab.json and merges.txt for models.text.
    # get_tokenizer; '' = the offline hash tokenizer
    tokenizer_path: str = ''
    # host pipeline backend: 'auto' takes the threaded C++ core
    # (embodiedscan_torch/native) where it builds, 'numpy' the numpy path;
    # the synthetic fixture always takes numpy
    native_pipeline: str = 'auto'
    # host/device overlap (reference num_workers=4, persistent_workers=True,
    # mv-det3d...py:182-183): num_workers threads build the samples of one
    # batch; prefetch_depth batches are staged ahead of the step by a
    # producer thread (0 = no prefetch)
    num_workers: int = 4
    prefetch_depth: int = 2


@dataclasses.dataclass
class ScheduleConfig:
    """AdamW + global-norm clip + MultiStepLR over epochs
    (configs/detection/mv-det3d...py:215-231). An epoch's length is the
    train loader's ``steps_per_epoch``, which ``train.loop.train`` passes
    to ``train.state.make_optimizer``."""
    max_epochs: int = 12
    lr: float = 1e-3
    weight_decay: float = 1e-4
    clip_norm: float = 10.0
    milestones: Sequence[int] = (8, 11)
    gamma: float = 0.1
    val_interval: int = 1
    # the global batch the preset's lr was tuned at (8 GPUs x the per-GPU
    # batch of the 8xbN config name): the --auto-scale-lr denominator
    # (reference tools/train.py:98-109, mmengine auto_scale_lr)
    base_batch_size: int = 32


@dataclasses.dataclass
class ModelConfig:
    task: str = 'mv_det3d'
    num_classes: int = 284
    voxel_size: float = 0.01
    input_capacity: int = 98304
    backbone_capacities: Sequence[int] = (65536, 32768, 24576, 8192, 4096,
                                          2048)
    fpn_capacities: Sequence[int] = (24576, 8192, 4096, 2048)
    resnet_depth: int = 50
    mink_depth: int = 34
    # test cfg (configs/detection/mv-det3d...py:58)
    nms_pre: int = 1000
    max_candidates: int = 1024
    max_dets: int = 256
    # 'reference' = yaw-truncated predictions as the published protocol;
    # 'full9d' keeps the predicted pitch/roll
    predict_protocol: str = 'reference'
    # grounding
    num_queries: int = 256
    max_text_len: int = 256
    text_arch: str = 'roberta'  # 'roberta' | 'tiny' (tests)
    text_layers: int = 12
    text_hidden: int = 768
    text_heads: int = 12
    # RoBERTa's word-embedding rows and LayerNorm epsilon. The defaults are
    # the JAX package's (BERT's 30522 rows, HF's RobertaConfig default
    # 1e-12); the mv_grounding presets set roberta-base's published 50265
    # and 1e-5 (its config.json)
    text_vocab_size: int = 30522
    text_ln_eps: float = 1e-12
    # rematerialization (models/remat.py): 'none' | '2d' | '3d' | 'all'
    # (True = 'all'). The reference's presets set '2d' (and 'all' for
    # cont_occ), sized for a 16 GB chip; on the 80 GB card every preset
    # steps without it (PERF.md), so the port's keep 'none'
    remat: str = 'none'
    # grounding box coder: 'baseline' | 'FCAF'
    box_coder: str = 'baseline'
    # the text encoder's output is detached (the reference's lr_mult=0)
    freeze_text: bool = True
    # grounding loss (configs/grounding/mv-grounding...py:63-92): the
    # matcher ('hungarian' on the host | 'auction' on the device), the
    # pairs the IoU match cost clips exactly (0 = max(2048, pairs // 8)),
    # the cost weights and the decoupled box loss's weights
    matcher: str = 'hungarian'
    iou_cost_capacity: int = 0
    cost_cls_weight: float = 1.0
    cost_l1_weight: float = 2.0
    cost_iou_weight: float = 2.0
    decouple_weights: Sequence[float] = (0.2, 0.2, 0.2, 0.4)
    # occupancy (configs/occupancy/mv-occ...py): 80 classes + empty, the
    # prior grid, the PointsRangeFilter bound (also the sparse branch's
    # origin), the 2D FPN's width, an optional 1x1 projection before the
    # U-Net (0 = off) and the 2D ResNet's base width
    occ_classes: int = 81
    n_voxels: Sequence[int] = (40, 40, 16)
    point_cloud_range: Sequence[float] = (-3.2, -3.2, -0.78, 3.2, 3.2, 1.78)
    occ_fpn_channels: int = 256
    occ_pre_neck_channels: int = 0
    # the U-Net computes in bfloat16 (parameters and batch-norm statistics
    # stay float32; cont_occ)
    occ_neck_bf16: bool = False
    resnet_base_channels: int = 64


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    work_dir: str = 'work_dirs/default'
    seed: int = 0
    log_interval: int = 50
    # scalar-curve backends: 'jsonl' appends work_dir/scalars.jsonl; add
    # 'tensorboard' (log_backends=jsonl,tensorboard) for event files in
    # work_dir/tb
    log_backends: Sequence[str] = ('jsonl', )
    resume: str = ''  # '', 'auto' (the latest checkpoint), or a step
    # the reference package's device count (0 = all); here one process
    # drives one card, so the count is the torch.distributed world size
    n_devices: int = 0
    profile_dir: str = ''  # if set, a torch.profiler trace of steps 5-10
    # evaluate() exports a scene PLY with the score-filtered predicted
    # boxes every vis_interval scenes into vis_dir (when set)
    vis_dir: str = ''
    vis_interval: int = 50
    vis_score_thr: float = 0.15


def mv_det3d() -> Config:
    """configs/detection/mv-det3d_8xb4_embodiedscan-3d-284class-9dof.py.
    ``model.remat`` stays 'none' where the reference package sets '2d': the
    b = 4 step peaks at 15.3 GiB of the 80 GB card (PERF.md)."""
    cfg = Config()
    cfg.work_dir = 'work_dirs/mv_det3d'
    cfg.data.repeat_times = 10
    return cfg


def cont_det3d() -> Config:
    """configs/detection/cont-det3d_8xb1_embodiedscan-3d-284class-9dof.py:
    the detector over a pseudo-batch of 1..V cumulative sweeps (10 train
    sweeps, cont-det3d...py:138 n_images=10)."""
    cfg = Config()
    cfg.model.task = 'cont_det3d'
    cfg.data.batch_size = 1
    cfg.data.n_views_train = 10
    cfg.schedule.base_batch_size = 8  # 8xb1
    cfg.work_dir = 'work_dirs/cont_det3d'
    return cfg


def mv_grounding() -> Config:
    """configs/grounding/mv-grounding_8xb12_embodiedscan-vg-9dof.py, its
    text encoder roberta-base as published (50265 rows, eps 1e-5)."""
    cfg = Config()
    cfg.model.task = 'mv_grounding'
    cfg.model.fpn_capacities = (1024, 1024, 1024, 2048)
    cfg.model.text_vocab_size = 50265
    cfg.model.text_ln_eps = 1e-5
    cfg.data.batch_size = 12
    # 64 padded gt boxes bound every published prompt family
    cfg.data.max_boxes = 64
    cfg.data.vg_file = 'embodiedscan_train_vg.json'
    cfg.schedule.lr = 5e-4
    cfg.schedule.weight_decay = 5e-4
    cfg.schedule.base_batch_size = 96  # 8xb12
    cfg.work_dir = 'work_dirs/mv_grounding'
    return cfg


def mv_grounding_mini() -> Config:
    """configs/grounding/mv-grounding_8xb12_embodiedscan-vg-9dof-mini.py:
    the 20%-data warm-up variant."""
    cfg = mv_grounding()
    cfg.data.vg_file = 'embodiedscan_train_mini_vg.json'
    cfg.work_dir = 'work_dirs/mv_grounding_mini'
    return cfg


def mv_grounding_complex() -> Config:
    """The mv-grounding complex-all variant: adds the complex prompts."""
    cfg = mv_grounding()
    cfg.data.vg_file = 'embodiedscan_train_vg_complex_all.json'
    cfg.work_dir = 'work_dirs/mv_grounding_complex'
    return cfg


def mv_occ() -> Config:
    """configs/occupancy/mv-occ_8xb1_embodiedscan-occ-80class.py (10 train
    and 20 test views, the 24-epoch schedule)."""
    cfg = Config()
    cfg.model.task = 'mv_occ'
    cfg.data.batch_size = 1
    cfg.data.n_views_train = 10
    cfg.data.n_views_test = 20
    cfg.schedule.max_epochs = 24
    cfg.schedule.milestones = (16, 22)
    cfg.schedule.base_batch_size = 8  # 8xb1
    cfg.work_dir = 'work_dirs/mv_occ'
    return cfg


def cont_occ() -> Config:
    """configs/occupancy/cont-occ_8xb1_embodiedscan-occ-80class.py: mv_occ's
    network over the sweep pseudo-batch, its U-Net in bfloat16. The
    reference package sets ``remat='all'`` here (for a 16 GB chip); the
    port keeps 'none': on the 80 GB card the 10-sweep step fits without
    recomputation (PERF.md). ``model.remat=all`` turns it on."""
    cfg = mv_occ()
    cfg.model.task = 'cont_occ'
    cfg.model.occ_neck_bf16 = True
    cfg.work_dir = 'work_dirs/cont_occ'
    return cfg


PRESETS = {
    'mv_det3d': mv_det3d,
    'cont_det3d': cont_det3d,
    'mv_grounding': mv_grounding,
    'mv_grounding_mini': mv_grounding_mini,
    'mv_grounding_complex': mv_grounding_complex,
    'mv_occ': mv_occ,
    'cont_occ': cont_occ,
}


def build_model(cfg: Config, device='cuda', img_dtype=torch.float32,
                generator: torch.Generator | None = None,
                bbox_mode: str = 'euler9d'):
    """The detector, grounder or occupancy model of ``cfg``, initialized
    from ``generator`` (default: a generator seeded with ``cfg.seed``), in
    eval mode on ``device``. ``bbox_mode`` is the detector head's box mode
    ('euler9d', 'yaw7d' or 'aa6d'): as in the reference, the config has no
    field for it.

    Raises when ``device`` is CUDA and no CUDA device is present; pass
    ``device='cpu'`` to run the plain versions of the kernels. Turns off
    TF32 for matrix products and cuDNN convolutions: the reference computes
    in float32.
    """
    from ..models.detector import SparseFusionDetector, init_weights
    from ..models.grounding import SparseFusionGrounder
    from ..models.occupancy import DenseFusionOccPredictor
    from ..models.remat import remat_mode
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('build_model: CUDA is not available; pass '
                           "device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.model
    if m.task in ('mv_det3d', 'cont_det3d'):
        model = SparseFusionDetector(
            num_classes=m.num_classes, voxel_size=m.voxel_size,
            input_capacity=m.input_capacity,
            backbone_capacities=tuple(m.backbone_capacities),
            fpn_capacities=tuple(m.fpn_capacities),
            resnet_depth=m.resnet_depth, mink_depth=m.mink_depth,
            nms_pre=m.nms_pre, max_candidates=m.max_candidates,
            max_dets=m.max_dets, img_dtype=img_dtype, bbox_mode=bbox_mode,
            predict_protocol=m.predict_protocol, remat=remat_mode(m.remat))
    elif bbox_mode != 'euler9d':
        raise ValueError(f'bbox_mode={bbox_mode!r} is for the detectors, '
                         f'not {m.task!r}')
    elif m.task == 'mv_grounding':
        model = SparseFusionGrounder(
            num_queries=m.num_queries, voxel_size=m.voxel_size,
            max_text_len=m.max_text_len, input_capacity=m.input_capacity,
            backbone_capacities=tuple(m.backbone_capacities),
            fpn_capacities=tuple(m.fpn_capacities),
            resnet_depth=m.resnet_depth, mink_depth=m.mink_depth,
            text_arch=m.text_arch, text_layers=m.text_layers,
            text_hidden=m.text_hidden, text_heads=m.text_heads,
            text_vocab_size=m.text_vocab_size, text_ln_eps=m.text_ln_eps,
            freeze_text=m.freeze_text, box_coder=m.box_coder,
            matcher=m.matcher, iou_cost_capacity=m.iou_cost_capacity,
            cost_cls_weight=m.cost_cls_weight,
            cost_l1_weight=m.cost_l1_weight,
            cost_iou_weight=m.cost_iou_weight,
            decouple_weights=tuple(m.decouple_weights), img_dtype=img_dtype,
            remat=remat_mode(m.remat))
    elif m.task in ('mv_occ', 'cont_occ'):
        model = DenseFusionOccPredictor(
            num_classes=m.occ_classes, n_voxels=tuple(m.n_voxels),
            point_cloud_range=tuple(m.point_cloud_range),
            input_capacity=m.input_capacity,
            backbone_capacities=tuple(m.backbone_capacities),
            resnet_depth=m.resnet_depth,
            resnet_base_channels=m.resnet_base_channels,
            mink_depth=m.mink_depth, fpn_channels=m.occ_fpn_channels,
            pre_neck_channels=m.occ_pre_neck_channels,
            neck_dtype=torch.bfloat16 if m.occ_neck_bf16 else torch.float32,
            # as the reference (configs/base.py:311): cont_occ alone
            remat=remat_mode(m.remat) if m.task == 'cont_occ' else 'none')
    else:
        raise ValueError(f'unknown task {m.task!r}')
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.to(device).eval()


def build_train(cfg: Config, device='cuda', *, steps_per_epoch: int):
    """(model in training mode, its optimizer): :func:`build_model`, then
    ``train.state.make_optimizer`` with the task's lr multipliers
    (``train.loop.lr_mult_fn_for``), which freeze the 2D stem and first
    stage of every task, and the grounder's text encoder; an epoch of the
    schedule is ``steps_per_epoch`` updates."""
    from ..train.loop import lr_mult_fn_for
    from ..train.state import make_optimizer
    model = build_model(cfg, device=device).train()
    return model, make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task),
                                 steps_per_epoch=steps_per_epoch)
