"""The port's copies of the text field, the PTB tokenizer and CIDEr-D give
the JAX package's outputs on the same strings: raw captions with
punctuation, quotes, brackets, contractions and capitals, the caption
corpus of tests/data, and decoded id rows with early and missing <eos>."""
import os

import numpy as np
import pytest

from vsrcic_tpu import metrics as jmetrics
from vsrcic_tpu import text as jtext
from vsrcic_tpu_torch import metrics as tmetrics
from vsrcic_tpu_torch import text as ttext

HERE = os.path.dirname(os.path.abspath(__file__))
RAW = [
    "A man riding a horse on the beach.",
    'She said "hello" (twice) -- then left...',
    "Two dogs aren't running; they're sitting: cannot move!",
    "The cat's toy is [red] and {blue}, isn't it?",
    "  gonna wanna   lemme gotta  ",
    "An 'old' man's hat, 3,000 miles away.",
    "",
]


def corpus():
    with open(os.path.join(HERE, "data", "spice_robustness_corpus.txt")) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def test_punctuation_lists_match():
    assert ttext.PUNCTUATIONS == jtext.PUNCTUATIONS


@pytest.mark.parametrize("source", ["raw", "corpus"])
def test_ptb_tokenize_matches_jax(source):
    caps = RAW if source == "raw" else corpus()
    assert ttext.ptb_tokenize(caps) == jtext.ptb_tokenize(caps)
    as_dict = {i: [c, c.upper()] for i, c in enumerate(caps)}
    assert ttext.ptb_tokenize(as_dict) == jtext.ptb_tokenize(as_dict)


@pytest.mark.parametrize("min_freq", [1, 2])
def test_text_field_matches_jax(min_freq):
    """Vocabulary order, numericalisation (truncation, <pad>, <unk>) and
    decoding up to the first <eos>, joined and not."""
    caps = corpus() + RAW
    fields = []
    for pkg in (jtext, ttext):
        tf = pkg.TextField(fix_length=12)
        tf.build_vocab(caps, min_freq=min_freq)
        fields.append(tf)
    jf, tf = fields
    assert tf.vocab.itos == jf.vocab.itos
    assert (tf.bos_idx, tf.eos_idx, tf.pad_idx) == (
        jf.bos_idx, jf.eos_idx, jf.pad_idx)
    ids = tf.process(caps + [["unseen", "words"]])
    np.testing.assert_array_equal(ids, jf.process(caps + [["unseen",
                                                            "words"]]))
    rows = np.random.RandomState(0).randint(0, len(tf.vocab), (40, 12))
    rows[3, 4] = tf.eos_idx
    rows[5] = tf.eos_idx
    for join in (True, False):
        assert tf.decode(rows, join_words=join) == jf.decode(
            rows, join_words=join)
        assert tf.decode(ids, join_words=join) == jf.decode(
            ids, join_words=join)
    words = tf.decode(rows, join_words=False)
    assert ([ttext.dedup_join(w) for w in words]
            == [jtext.dedup_join(w) for w in words])


@pytest.mark.parametrize("df", ["corpus", "batch"])
def test_cider_matches_jax(df):
    """Per-caption CIDEr-D, and the pair scoring of SCST's reward, equal
    to the last bit: with the document frequency of a corpus (the SCST
    reward's mode) and of the scored batch."""
    caps = jtext.ptb_tokenize(corpus())
    rng = np.random.RandomState(1)
    gts = {i: [caps[j] for j in rng.choice(len(caps), 3)]
           for i in range(40)}
    res_a = {i: [caps[rng.randint(len(caps))]] for i in range(40)}
    res_b = {i: [gts[i][0] if i % 3 else ""] for i in range(40)}
    kw = {"gts": {i: [c] for i, c in enumerate(caps)}} if df == "corpus" \
        else {}
    jc, tc = jmetrics.Cider(**kw), tmetrics.Cider(**kw)
    mean_j, per_j = jc.compute_score(gts, res_a)
    mean_t, per_t = tc.compute_score(gts, res_a)
    assert mean_t == mean_j
    np.testing.assert_array_equal(per_t, per_j)
    for got, want in zip(tc.compute_score_pair(gts, res_a, res_b),
                         jc.compute_score_pair(gts, res_a, res_b)):
        np.testing.assert_array_equal(got, want)
    lists = [gts[i] for i in range(40)], [res_a[i][0] for i in range(40)]
    np.testing.assert_array_equal(tc.compute_score(*lists)[1],
                                  jc.compute_score(*lists)[1])
