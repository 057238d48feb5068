"""The port's byte-level BPE tokenizer (``models/text.py:BPETokenizer``)
against ``RobertaTokenizerFast``: the recorded ids, masks and
``char_to_token`` tables of ``tests/fixtures/roberta_tok/recorded.json``,
the JAX package's ``build_positive_maps`` driven by its ``HFTokenizer`` on
the spans of ``tests/test_tokenizer_fixture.py``, and the live fast
tokenizer on prompts that exercise the pre-tokenizer (digits, punctuation,
capitals, runs of spaces, contractions, non-ASCII letters, truncation).
Everything is compared exactly.
"""

import json
import os

import numpy as np
import pytest

from embodiedscan_tpu.models import text as jT
from embodiedscan_torch.models import text as tT

FIXDIR = os.path.join(os.path.dirname(__file__), 'fixtures', 'roberta_tok')
SPANS = [  # tests/test_tokenizer_fixture.py's positive-map spans
    [[[0, 3]], [[4, 13]]],
    [[[2, 12]], [[7, 31]]],
    [[[5, 15]], [[29, 37]]],
    [[[4, 11]], [[12, 28]]],
]
EXTRA = [
    'The 3 chairs, near 2 tables!',
    "it's the  red   chair's leg; we'll see",
    'the café near the DESK',
    'find\tthe\nlamp  ',
    '  two leading spaces',
    "don't we've they're I'm you'd it'll",
    'naïve ①② Ⅻ 3.14 -- ?? (the sofa)',
    '日本語の机 一二三 ١٢٣',
    '',
    ' '.join(['the red chair next to the table'] * 12),  # > max_len tokens
]


@pytest.fixture(scope='module')
def recorded():
    with open(os.path.join(FIXDIR, 'recorded.json')) as f:
        return json.load(f)


def test_matches_recording(recorded):
    tok = tT.BPETokenizer(FIXDIR, max_len=recorded['max_len'])
    assert tok.vocab_size == 395
    out = tok(recorded['prompts'])
    assert out['input_ids'].dtype == out['attention_mask'].dtype == np.int32
    np.testing.assert_array_equal(out['input_ids'], recorded['input_ids'])
    np.testing.assert_array_equal(out['attention_mask'],
                                  recorded['attention_mask'])
    for i, table in enumerate(recorded['char_to_token']):
        assert [tok.char_to_token(i, c) for c in range(len(table))] == table


def test_positive_maps_match_reference(recorded):
    prompts, max_len = recorded['prompts'], recorded['max_len']
    hf = jT.HFTokenizer(FIXDIR, max_len=max_len)
    hf(prompts)
    want = jT.build_positive_maps(hf, prompts, SPANS, max_len, max_boxes=2)
    tok = tT.BPETokenizer(FIXDIR, max_len=max_len)
    tok(prompts)
    got = tT.build_positive_maps(tok, prompts, SPANS, max_len, max_boxes=2)
    np.testing.assert_array_equal(got, want)
    assert (got.max(-1) < 0.6).any() and got.sum() > 0


@pytest.mark.parametrize('max_len', [24, 64])
def test_matches_live_fast_tokenizer(max_len):
    hf = jT.HFTokenizer(FIXDIR, max_len=max_len)
    tok = tT.BPETokenizer(FIXDIR, max_len=max_len)
    want, got = hf(EXTRA), tok(EXTRA)
    for key in ('input_ids', 'attention_mask'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got['attention_mask'][-1].all()  # the long prompt was cut
    for i, text in enumerate(EXTRA):
        for c in range(len(text)):
            assert tok.char_to_token(i, c) == hf.char_to_token(i, c), \
                (text, c)
        assert tok.char_to_token(i, len(text)) is None


def test_pretokenizer_splits():
    def split(text):
        out, i = [], 0
        while i < len(text):
            j = tT._pretoken_end(text, i)
            out.append(text[i:j])
            i = j
        return out

    assert split("it's  the red-chair's 2x") == [
        'it', "'s", ' ', ' the', ' red', '-', 'chair', "'s", ' 2', 'x']
    assert split('a\t b  ') == ['a', '\t', ' b', '  ']
    assert split('café 12') == ['café', ' 12']


def test_get_tokenizer():
    assert isinstance(tT.get_tokenizer('', 16), tT.SimpleTokenizer)
    tok = tT.get_tokenizer(FIXDIR, 16)
    assert isinstance(tok, tT.BPETokenizer) and tok.max_len == 16
    with pytest.raises(FileNotFoundError):
        tT.get_tokenizer(os.path.dirname(FIXDIR), 16)
