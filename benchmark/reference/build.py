"""The benchmark's plain reference: builds the detector or the occupancy
model of a configuration file from this folder's frozen modules, takes
the training step's loss, clip and AdamW in plain tensor operations, and
serves a request. Imports nothing of the program."""

import torch

FROZEN = ('stem_conv', 'stem_bn', 'layer1_')


def plain_float32():
    """Matrix products and convolutions in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(model: dict, *, max_dets: int | None = None) -> torch.nn.Module:
    """The model of a configuration file's ``model`` section, on the
    current default device, with its constructed (not yet seeded) weights.
    ``max_dets``: the detector's kept candidates (the check keeps all)."""
    from .models.detector import SparseFusionDetector
    from .models.occupancy import DenseFusionOccPredictor
    m = model
    if m['task'] == 'mv_det3d':
        return SparseFusionDetector(
            num_classes=m['num_classes'], voxel_size=m['voxel_size'],
            input_capacity=m['input_capacity'],
            backbone_capacities=tuple(m['backbone_capacities']),
            fpn_capacities=tuple(m['fpn_capacities']),
            resnet_depth=m['resnet_depth'], mink_depth=m['mink_depth'],
            nms_pre=m['nms_pre'], max_candidates=m['max_candidates'],
            max_dets=m['max_dets'] if max_dets is None else max_dets,
            bbox_mode=m['bbox_mode'], predict_protocol=m['predict_protocol'])
    if m['task'] == 'mv_occ':
        return DenseFusionOccPredictor(
            num_classes=m['occ_classes'], n_voxels=tuple(m['n_voxels']),
            point_cloud_range=tuple(m['point_cloud_range']),
            input_capacity=m['input_capacity'],
            backbone_capacities=tuple(m['backbone_capacities']),
            resnet_depth=m['resnet_depth'],
            resnet_base_channels=m['resnet_base_channels'],
            mink_depth=m['mink_depth'], fpn_channels=m['occ_fpn_channels'],
            pre_neck_channels=m['occ_pre_neck_channels'])
    raise ValueError(f'no reference for task {m["task"]!r}')


def trained(name: str) -> bool:
    """Whether the parameter ``name`` is trained (the 2D stem and first
    stage are frozen: ``frozen_stages=1``)."""
    return not any(f in name for f in FROZEN)


class PlainAdamW:
    """Per-group global-norm clip, then AdamW (betas 0.9 / 0.999, eps 1e-8,
    decoupled weight decay), in plain tensor operations. A trained
    parameter the loss does not reach takes a zero gradient."""

    def __init__(self, named_params, lr, weight_decay, clip_norm,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = [(n, p) for n, p in named_params]
        self.lr, self.wd, self.clip = lr, weight_decay, clip_norm
        self.b1, self.b2 = betas
        self.eps = eps
        self.count = 0
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}

    @torch.no_grad()
    def clipped_grads(self) -> dict:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in
                              grads.values())).float()
        scale = torch.clamp(self.clip / norm, max=1.0)
        return {n: g * scale for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for n, p in self.params:
            g = grads[n]
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))


def train_step(model, opt: PlainAdamW, batch: dict):
    """One step: the loss terms, backward, clip, AdamW. Returns (the loss
    terms as floats, the clipped gradients)."""
    for _, p in opt.params:
        p.grad = None
    losses = model(batch, mode='loss')
    sum(losses.values()).backward()
    grads = opt.clipped_grads()
    opt.step(grads)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@torch.no_grad()
def predict(model, batch: dict):
    """The served outputs of one request: the detector's candidates (all
    of them, with the NMS keep mask), or the occupancy model's per-scale
    logits, finest first."""
    if hasattr(model, 'bbox_head'):
        return model(batch, mode='predict')
    return model(batch, mode='feats')
