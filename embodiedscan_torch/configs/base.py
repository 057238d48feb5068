"""Configs, their ``a.b=c`` overrides and the model entry point (port of
the detection and grounding parts of ``embodiedscan_tpu/configs/base.py``).
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
    n_views_train: int = 20
    n_views_test: int = 50
    n_points: int = 100000
    image_hw: Sequence[int] = (480, 480)
    n_gt: int = 128  # padded ground-truth boxes per training scene
    max_boxes: int = 200  # padded gt boxes per grounding prompt
    # directory of RoBERTa's vocab.json and merges.txt for models.text.
    # get_tokenizer; '' = the offline hash tokenizer
    tokenizer_path: str = ''


@dataclasses.dataclass
class ScheduleConfig:
    """AdamW + global-norm clip + MultiStepLR
    (configs/detection/mv-det3d...py:215-231); an epoch is
    ``steps_per_epoch`` updates."""
    lr: float = 1e-3
    weight_decay: float = 1e-4
    clip_norm: float = 10.0
    milestones: Sequence[int] = (8, 11)
    steps_per_epoch: int = 1000


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


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    seed: int = 0


def mv_det3d() -> Config:
    """configs/detection/mv-det3d_8xb4_embodiedscan-3d-284class-9dof.py."""
    return Config()


def mv_grounding() -> Config:
    """configs/grounding/mv-grounding_8xb12_embodiedscan-vg-9dof.py (the
    model, the schedule and the gt padding; its data files wait for the
    data slice)."""
    cfg = Config()
    cfg.model.task = 'mv_grounding'
    cfg.model.fpn_capacities = (1024, 1024, 1024, 2048)
    # 64 padded gt boxes bound every published prompt family
    cfg.data.max_boxes = 64
    cfg.schedule.lr = 5e-4
    cfg.schedule.weight_decay = 5e-4
    return cfg


PRESETS = {'mv_det3d': mv_det3d, 'mv_grounding': mv_grounding}


def build_model(cfg: Config, device='cuda', img_dtype=torch.float32,
                generator: torch.Generator | None = None):
    """The detector or grounder of ``cfg``, initialized from ``generator``
    (default: a generator seeded with ``cfg.seed``), in eval mode on
    ``device``.

    Raises when ``device`` is CUDA and no CUDA device is present; pass
    ``device='cpu'`` to run the plain versions of the kernels. Turns off
    TF32 for matrix products and cuDNN convolutions: the reference computes
    in float32.
    """
    from ..models.detector import SparseFusionDetector, init_weights
    from ..models.grounding import SparseFusionGrounder
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('build_model: CUDA is not available; pass '
                           "device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.model
    if m.task == 'mv_det3d':
        model = SparseFusionDetector(
            num_classes=m.num_classes, voxel_size=m.voxel_size,
            input_capacity=m.input_capacity,
            backbone_capacities=tuple(m.backbone_capacities),
            fpn_capacities=tuple(m.fpn_capacities),
            resnet_depth=m.resnet_depth, mink_depth=m.mink_depth,
            nms_pre=m.nms_pre, max_candidates=m.max_candidates,
            max_dets=m.max_dets, img_dtype=img_dtype,
            predict_protocol=m.predict_protocol)
    elif m.task == 'mv_grounding':
        model = SparseFusionGrounder(
            num_queries=m.num_queries, voxel_size=m.voxel_size,
            max_text_len=m.max_text_len, input_capacity=m.input_capacity,
            backbone_capacities=tuple(m.backbone_capacities),
            fpn_capacities=tuple(m.fpn_capacities),
            resnet_depth=m.resnet_depth, mink_depth=m.mink_depth,
            text_arch=m.text_arch, text_layers=m.text_layers,
            text_hidden=m.text_hidden, text_heads=m.text_heads,
            freeze_text=m.freeze_text, box_coder=m.box_coder,
            matcher=m.matcher, iou_cost_capacity=m.iou_cost_capacity,
            cost_cls_weight=m.cost_cls_weight,
            cost_l1_weight=m.cost_l1_weight,
            cost_iou_weight=m.cost_iou_weight,
            decouple_weights=tuple(m.decouple_weights), img_dtype=img_dtype)
    else:
        raise NotImplementedError(f'task {m.task!r} is not ported yet')
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.to(device).eval()


def build_train(cfg: Config, device='cuda'):
    """(model in training mode, its optimizer): :func:`build_model`, then
    ``train.state.make_optimizer`` with the task's lr multipliers
    (``train.loop.lr_mult_fn_for``), which freeze the 2D stem and first
    stage, and the grounder's text encoder."""
    from ..train.loop import lr_mult_fn_for
    from ..train.state import make_optimizer
    model = build_model(cfg, device=device).train()
    return model, make_optimizer(model, cfg, lr_mult_fn_for(cfg.model.task))
