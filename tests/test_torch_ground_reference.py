"""The port's grounder against the benchmark's plain reference grounder
(``benchmark/reference/models/grounding.py``, plain float32 torch that
imports nothing of the port), at a small size on the CPU, on the
benchmark's seeded weights (``benchmark/harness/weights.py`` with
``benchmark/tasks/mv_grounding.py``'s rules) and prompts
(``benchmark/traffic/scenes/ground_room.py``); also the published text
vocabulary and norm of the ``mv_grounding`` presets, the grounder's
profiler spans and its neck's live-location counter.

Two batches of two scenes: the seeded rooms, and a twin whose second
sample keeps 6 points. The neck's capacities are cut to (4, 4, 4, 32),
as the JAX parity test's few-rows grounder, so that the twin's neck has
fewer live rows than queries (masked queries, ties among the -inf
selection scores).

Integers are exact: the selected neck rows, the query mask. Floats agree
within ``TOL``: both sides compute in float32 the same equations with
their operations in another order (the port scales a query before its
product with the keys, the reference the product; the embeddings are
summed in another order; the port sorts monotone integer keys, the
reference the scores), which moves results by a few ulps per operation
through the trunk, the neck, 2 RoBERTa layers and 6 decoder layers
(observed: at most 1.9e-6 absolute, in the token logits).
"""

import dataclasses

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness import weights as W
from benchmark.traffic import generate as G
from embodiedscan_torch.configs import base
from embodiedscan_torch.models.grounding import MinkNeck
from embodiedscan_torch.models.text import TextEncoder

TOL = dict(atol=1e-4, rtol=1e-5)
SMALL = dict(voxel_size=0.05, input_capacity=512,
             backbone_capacities=(512, 256, 256, 128, 64, 32),
             fpn_capacities=(4, 4, 4, 32), resnet_depth=18, mink_depth=18,
             num_queries=16, max_text_len=64, text_layers=2, text_hidden=32,
             text_heads=4)
TRAFFIC = dict(scene='ground_room', batch=2, points=1500, views=2,
               image_hw=32, prompt_tokens=[12, 48], pool=1)
SEED = 3000000019


def _cfg():
    cfg = base.mv_grounding()
    for key, val in SMALL.items():
        setattr(cfg.model, key, val)
    return cfg


@pytest.fixture(scope='module')
def pair():
    """The port's grounder (``build_model``) and the reference, with the
    same seeded weights, and the two batches."""
    cfg = _cfg()
    model = dataclasses.asdict(cfg.model)
    task = spec.task('mv_grounding')
    plan = W.plan(task, model)
    port = base.build_model(cfg, device='cpu')
    W.load(port, plan, SEED)
    ref = task.build(model).eval()
    W.load(ref, plan, SEED)
    conf = dict(model=model)
    room = G.batch(TRAFFIC, conf, SEED, 0, 'cpu')
    sparse = {k: v.clone() for k, v in room.items()}
    sparse['points_mask'][1] = False
    sparse['points_mask'][1, :6] = True
    sparse['points'][1, :6] = torch.linspace(0.5, 0.7, 18).reshape(6, 3)
    return port, ref, task, {'room': room, 'sparse': sparse}


@pytest.mark.parametrize('batch', ['room', 'sparse'])
def test_port_matches_plain_reference(pair, batch):
    port, ref, task, batches = pair
    b = batches[batch]
    with torch.no_grad():
        feats, _, xyz, mask = port.neck(port.trunk(b))
        text = port.text_encoder(b['text_ids'], b['text_mask'])
        enc_cls = port.cls_embed(feats, text, b['text_mask'] > 0, mask)
        outs = port(b, mode='feats')
        preds = port(b, mode='predict')
    want = task.predict(ref, b)
    torch.testing.assert_close(preds['query_index'], want['query_index'],
                               rtol=0, atol=0)
    assert torch.equal(outs.query_index, preds['query_index'])
    assert torch.equal(preds['mask'], want['mask'])
    live = mask.sum(1)
    if batch == 'sparse':  # the case the twin is built for
        assert int(live[1]) < SMALL['num_queries']
        assert not bool(preds['mask'][1].all())
    else:
        assert bool((live >= SMALL['num_queries']).all())
    assert torch.equal(live, want['live'])
    torch.testing.assert_close(enc_cls, want['enc_cls'], **TOL)
    assert outs.cls.shape == want['cls'].shape == (6, 2, 16, 64)
    torch.testing.assert_close(outs.cls, want['cls'], **TOL)
    torch.testing.assert_close(outs.boxes, want['boxes'], **TOL)
    for key in ('bboxes', 'scores'):
        torch.testing.assert_close(preds[key], want[key], **TOL)
    # the teacher-forced decoder of the benchmark's comparison, at the
    # reference's own selection, is the reference's answer itself
    again = want['replay'](want['query_index'])
    assert torch.equal(again['scores'], want['scores'])


def test_presets_take_the_published_text_encoder():
    """The mv_grounding presets: roberta-base's 50265 rows and eps 1e-5;
    the field defaults (every other preset, the JAX package's) 30522 and
    1e-12. The preset's encoder (two layers here) embeds ids past 30522,
    every LayerNorm at 1e-5."""
    for name in ('mv_grounding', 'mv_grounding_mini', 'mv_grounding_complex'):
        m = base.PRESETS[name]().model
        assert (m.text_vocab_size, m.text_ln_eps) == (50265, 1e-5), name
    for name in ('mv_det3d', 'cont_det3d', 'mv_occ', 'cont_occ'):
        m = base.PRESETS[name]().model
        assert (m.text_vocab_size, m.text_ln_eps) == (30522, 1e-12), name
    m = base.mv_grounding().model
    torch.manual_seed(0)
    enc = TextEncoder(256, vocab_size=m.text_vocab_size, hidden=m.text_hidden,
                      layers=2, heads=m.text_heads, ln_eps=m.text_ln_eps)
    emb = enc.FlaxRobertaModule_0.embeddings.word_embeddings
    assert emb.weight.shape == (50265, 768)
    norms = [mod for mod in enc.modules()
             if isinstance(mod, torch.nn.LayerNorm)]
    assert len(norms) == 5 and all(n.eps == 1e-5 for n in norms)
    ids = torch.tensor([[0, 30522, 50264, 2, 1, 1]])
    mask = torch.tensor([[1, 1, 1, 1, 0, 0]])
    with torch.no_grad():
        out = enc(ids, mask)
        other = enc(torch.tensor([[0, 30521, 50263, 2, 1, 1]]), mask)
    assert out.shape == (1, 6, 256) and torch.isfinite(out).all()
    assert not torch.allclose(out[0, 1], other[0, 1])


def test_spans_and_live_counter(pair, tmp_path):
    """One predict under the profiler holds ``es.neck``, ``es.text``,
    ``es.select`` and ``es.decoder`` once each, on one thread, in that
    order; the neck's counter adds its live rows."""
    import json
    port, _, _, batches = pair
    b = batches['room']
    MinkNeck.live_counts.clear()
    with torch.profiler.profile() as prof:
        with torch.no_grad():
            port(b, mode='predict')
    live = int(MinkNeck.live_counts[None])
    with torch.no_grad():
        mask = port.neck(port.trunk(b))[3]
    assert live == int(mask.sum())
    assert mask.numel() == 2 * sum(SMALL['fpn_capacities'])
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    spans = sorted((e['ts'], e['name'], e['tid'])
                   for e in json.loads(path.read_text())['traceEvents']
                   if e.get('cat') == 'user_annotation' and
                   e['name'] in ('es.neck', 'es.text', 'es.select',
                                 'es.decoder'))
    assert [s[1] for s in spans] == ['es.neck', 'es.text', 'es.select',
                                     'es.decoder']
    assert len({s[2] for s in spans}) == 1
