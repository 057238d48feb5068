"""The 3D visual grounding task (``SparseFusionGrounder``: the detector's
trunk, MinkNeck, RoBERTa, the top-k query selection and the 6-layer
decoder): its reference model, its trained parameters, its weight rules
and how its served queries are compared.

Serving is compared over every request of the window. Query selection is
a top-k over the neck's locations, so a location whose score lies within
rounding of the k-th best may fall on either side of the cut, and through
the decoder's self-attention one other query moves every query a little.
The decoder's numbers are therefore read against the reference's decoder
run over the program's own selection (as the detector's ``nms_diff``
runs the reference's NMS over the program's candidates), and the
selection is held to the reference's own apart:

- ``query_diff``: per request, the selected neck rows of the program that
  the reference's own top-k lacks, plus the queries whose mask differs;
- ``score_gap``: each query's best token probability, rank by rank,
  |program - reference| / max(reference, the cell's ``score_floor``),
  the worst;
- ``box_gap``: each live query's box against the reference's box of the
  same query, the largest over the fields of |program - reference| /
  max(|reference|, 1): metres, or a share of sizes above 1 m, and
  radians; the worst;
- ``logit_gap``: the token logits of every ContrastiveEmbed call (the
  selection's over every neck location, then each decoder layer's) of a
  sample of requests drawn from the seed: max |program - reference| /
  max |reference| over the entries the reference does not fill with
  -1e4, per call; an entry filled on one side only is infinite.
"""

import math

import torch

from benchmark.harness.cells import log
from benchmark.harness.check import worse
from benchmark.reference.models.fcaf3d import _CLS_BIAS
from benchmark.reference.models.grounding import NEG

FROZEN = ('stem_conv', 'stem_bn', 'layer1_', 'text_encoder.')
# roberta-base's initializer_range: its embeddings and dense layers
TEXT_STD = 0.02
# the box branch's output, small enough that exp() of the log sizes stays
# near 1 m (the port starts it at zero, which would make every box alike)
BOX_STD = 0.01


def build(model: dict, serve: bool = False) -> torch.nn.Module:
    """The grounder of the configuration's ``model`` section (the same for
    serving)."""
    from benchmark.reference.models.grounding import SparseFusionGrounder
    m = model
    if m['text_arch'] != 'roberta' or m['box_coder'] != 'baseline':
        raise ValueError('the reference grounder has RoBERTa and the '
                         'baseline box coder alone')
    return SparseFusionGrounder(
        num_queries=m['num_queries'], voxel_size=m['voxel_size'],
        max_text_len=m['max_text_len'], input_capacity=m['input_capacity'],
        backbone_capacities=tuple(m['backbone_capacities']),
        fpn_capacities=tuple(m['fpn_capacities']),
        resnet_depth=m['resnet_depth'], mink_depth=m['mink_depth'],
        text_layers=m['text_layers'], text_hidden=m['text_hidden'],
        text_heads=m['text_heads'], text_vocab_size=m['text_vocab_size'],
        text_ln_eps=m['text_ln_eps'])


def trained(name: str) -> bool:
    """Whether the parameter ``name`` is trained: not the 2D stem and first
    stage (``frozen_stages=1``), not the text encoder (lr_mult 0)."""
    return not any(f in name for f in FROZEN)


def weight_rules(ref) -> dict:
    """RoBERTa's embeddings and dense layers at N(0, 0.02), as published
    (the generic rule fills an embedding with 1); the box branch's output
    at N(0, 0.01); ContrastiveEmbed's bias at the prior probability's
    logit, as the port initializes it."""
    rules = {}
    text = ref.text_encoder.FlaxRobertaModule_0
    for mod_name, mod in text.named_modules():
        if isinstance(mod, (torch.nn.Embedding, torch.nn.Linear)):
            rules[f'text_encoder.FlaxRobertaModule_0.{mod_name}.weight'] = \
                ('normal', TEXT_STD)
    rules['reg_branch.out.weight'] = ('normal', BOX_STD)
    rules['cls_embed.bias'] = ('const', _CLS_BIAS)
    return rules


@torch.no_grad()
def predict(model, batch: dict):
    """The reference's answer (its own selection and decoder), the
    selection's logits, and ``replay(index)``: its decoder over the queries
    at the neck rows ``index``."""
    enc = model.encode(batch)
    out = model.decode(enc, model.select(enc))

    @torch.no_grad()
    def replay(index):
        return model.decode(enc, index)

    out.update(enc_cls=enc['enc_cls'], live=enc['mask'].sum(1),
               replay=replay)
    return out


def _logit_gap(prog, ref):
    """max |prog - ref| / max |ref| over the entries ``ref`` does not fill;
    infinite where one side alone fills an entry."""
    prog = prog.to(ref.device).float()
    if prog.shape != ref.shape:
        return math.inf
    filled = ref == NEG
    if ((prog == NEG) != filled).any():
        return math.inf
    d = torch.where(filled, 0.0, (prog - ref).abs()).amax()
    scale = torch.where(filled, 0.0, ref.abs()).amax()
    return float(d / scale.clamp(min=1e-30))


def compare_serve(outs: list, logits: list, refs: dict, work: dict,
                  device) -> dict:
    """``outs``: [(scene index, the program's answer)] of every request;
    ``logits``: [(request, scene index, [per-sample token logits])], one
    entry per ContrastiveEmbed call of the sampled requests, in call order;
    ``refs``: scene index -> :func:`predict`'s answer."""
    floor = work['score_floor']
    s0 = outs[0][1]['scores'][0]
    log(f'request 0 served scores {float(s0.min())!r} to '
        f'{float(s0.max())!r}; the reference\'s neck keeps '
        f'{int(refs[outs[0][0]]["live"][0])} live locations')
    worst, replays = {}, {}
    for i, (scene, out) in enumerate(outs):
        ref = refs[scene]
        index = out['query_index'].to(device).long()
        key = (scene, index.cpu().numpy().tobytes())
        if key not in replays:
            replays[key] = ref['replay'](index)
        r = replays[key]
        own = ref['query_index']
        lacking = sum(int((~torch.isin(index[b], own[b])).sum())
                      for b in range(index.shape[0]))
        mask = out['mask'].to(device)
        worse(worst, 'query_diff', lacking + int((mask != r['mask']).sum()),
              f'request {i}')
        s, sr = out['scores'].to(device), r['scores']
        worse(worst, 'score_gap', ((s - sr).abs() / sr.clamp(min=floor)
                                   ).amax(), f'request {i}')
        rel = (out['bboxes'].to(device) - r['bboxes']).abs() / \
            r['bboxes'].abs().clamp(min=1.0)
        rel = torch.where(torch.isfinite(rel), rel,
                          torch.full_like(rel, math.inf)).amax(-1)
        worse(worst, 'box_gap', torch.where(r['mask'], rel,
                                            torch.zeros_like(rel)).amax(),
              f'request {i}')
    calls = {}
    for i, scene, prog in logits:
        calls.setdefault(i, (scene, []))[1].append(prog)
    for i, (scene, prog) in calls.items():
        ref = refs[scene]
        index = outs[i][1]['query_index'].to(device).long()
        r = replays[(scene, index.cpu().numpy().tobytes())]
        want = [ref['enc_cls']] + list(r['cls'])
        if len(prog) != len(want):
            worse(worst, 'logit_gap', math.inf, f'request {i}: '
                  f'{len(prog)} calls against {len(want)}')
        for k, (p, w) in enumerate(zip(prog, want)):
            for b, pb in enumerate(p):
                worse(worst, 'logit_gap', _logit_gap(pb, w[b]),
                      f'request {i} call {k}')
    return worst
