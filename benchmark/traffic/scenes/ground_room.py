"""``ground_room``: a ``det_room`` (``det_room.py``, drawn first from the
same generator) and one prompt: its length drawn uniformly from the
traffic's ``prompt_tokens`` [low, high] (the tokens with ``<s>`` and
``</s>``), RoBERTa's ``<s>`` (0), token ids uniform over [3, the
configuration's ``text_vocab_size``), ``</s>`` (2), then the pad id 1 up
to ``max_text_len``; ``text_mask`` 1 over the prompt, 0 over the pad."""

from pathlib import Path

import torch

from benchmark.harness.spec import load_file

BOS, PAD, EOS = 0, 1, 2
FIRST_ID = 3   # the ids below are <s>, <pad>, </s>


def make(t: dict, conf: dict, g, device) -> dict:
    room = load_file('scene', Path(__file__).with_name('det_room.py'))
    scene = room.make(t, conf, g, device)
    m = conf['model']
    low, high = t['prompt_tokens']
    n = int(torch.randint(low, high + 1, (1, ), generator=g, device=device))
    ids = torch.full((m['max_text_len'], ), PAD, dtype=torch.int32,
                     device=device)
    ids[0], ids[n - 1] = BOS, EOS
    ids[1:n - 1] = torch.randint(FIRST_ID, m['text_vocab_size'], (n - 2, ),
                                 generator=g, device=device,
                                 dtype=torch.int32)
    mask = torch.zeros_like(ids)
    mask[:n] = 1
    scene.update(text_ids=ids, text_mask=mask)
    return scene
