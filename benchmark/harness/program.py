"""The system under test: the port's model, optimizer, train step and
request path, built from a configuration file through the port's own
entry points (``configs.base.build_model`` / ``build_train``), with the
benchmark's seeded weights (``weights``) in place of the port's host
initialization."""

import contextlib

import torch

from . import weights as W


def port_config(conf: dict):
    """The port's ``Config`` of the preset the file names, with the file's
    model and schedule fields set (each must be a field of the port's)."""
    from embodiedscan_torch.configs.base import PRESETS
    cfg = PRESETS[conf['preset']]()
    for section in ('model', 'schedule'):
        obj = getattr(cfg, section)
        for key, val in conf[section].items():
            if section == 'model' and key == 'bbox_mode':
                continue
            cur = getattr(obj, key)
            setattr(obj, key, type(cur)(val) if isinstance(cur, (tuple, list))
                    else val)
    return cfg


@contextlib.contextmanager
def _no_host_init():
    """``build_model`` without the port's host initialization: modules are
    made on the default device and keep their constructed values until
    :func:`weights.load` overwrites them."""
    from embodiedscan_torch.models import detector as D
    init = D.init_weights
    D.init_weights = lambda model, generator: model
    try:
        yield
    finally:
        D.init_weights = init


# The port's multistep schedule lowers the rate after epochs 8 and 11 of
# this many updates; a run makes a few hundred, all at the base rate.
STEPS_PER_EPOCH = 1000


def build(conf: dict, train: bool, seed: int, device, plan: list):
    """(model, optimizer or None) of the configuration on ``device``, the
    weights of ``plan`` (``weights.plan``) under ``seed`` loaded; the model
    in training mode with its optimizer for ``train``, else in eval
    mode."""
    from embodiedscan_torch.configs.base import build_model, build_train
    cfg = port_config(conf)
    with _no_host_init(), torch.device(device):
        if train:
            model, opt = build_train(cfg, device=device,
                                     steps_per_epoch=STEPS_PER_EPOCH)
        else:
            model = build_model(cfg, device=device,
                                generator=torch.Generator(),
                                bbox_mode=conf['model']['bbox_mode']
                                if 'bbox_mode' in conf['model'] else
                                'euler9d')
            opt = None
    W.load(model, plan, seed)
    return model, opt


def train_step(model, opt, batch: dict) -> dict:
    from embodiedscan_torch.train.state import train_step as step
    return step(model, opt, batch)


def request(model, batch_np: dict, device):
    """One served request as a user hands it over: a numpy batch (backed by
    pinned host memory) through the port's ``data.loader.to_device``, the
    model's ``mode='predict'``, and its outputs copied to the host."""
    from embodiedscan_torch.data.loader import to_device
    out = model(to_device(batch_np, device), mode='predict')
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    return out.cpu()


def set_control(on: bool) -> None:
    """The lower-precision control: the port's own bf16 sparse-conv route
    (``set_conv_compute_dtype(torch.bfloat16)``) with TF32 on for matrix
    products and cuDNN; ``on=False`` restores float32."""
    from embodiedscan_torch.ops.sparse import set_conv_compute_dtype
    set_conv_compute_dtype(torch.bfloat16 if on else None)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
