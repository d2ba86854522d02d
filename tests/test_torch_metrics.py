"""The port's eval metrics (`vsrcic_tpu_torch.metrics`: BLEU 1-4, ROUGE-L,
native METEOR, native SPICE, the jar wrappers) against the JAX package's,
corpus score and per-image scores, on the caption sets of
tests/test_bleu_rouge_golden.py, tests/test_meteor.py and
tests/test_spice_native.py.

Tolerance 0: both sides run the same numpy code in float64 in the same
order, so every score is compared with ==.
"""
import numpy as np
import pytest

from vsrcic_tpu import metrics as jax_metrics
from vsrcic_tpu.metrics import spice as jax_spice
from vsrcic_tpu_torch import metrics as torch_metrics
from vsrcic_tpu_torch.metrics import spice as torch_spice

from test_bleu_rouge_golden import _corpus
from test_spice_native import CASES as SPICE_CASES

METEOR_SETS = [
    ({1: ["the cat sat"], 2: ["a big dog runs far away today ok"]},
     {1: ["the cat sat"], 2: ["entirely unrelated words here"]}),
    ({"a": ["x y z", "x y"], "b": ["q r"]}, {"a": ["x y z"], "b": ["q z"]}),
    ({0: ["a cat sits on the mat"], 1: ["the cat sat down"],
      2: ["he running quick"], 3: ["a dog", "the cat sat"],
      4: ["the dog the cat"], 5: ["elephant"], 6: ["a cat"]},
     {0: ["mat the on sits cat a"], 1: ["the cat sat"],
      2: ["he runs quickly"], 3: ["the cat sat"], 4: ["the cat the dog"],
      5: ["dog"], 6: [""]}),
]
SPICE_SETS = [
    ({0: ["a man riding a horse on a beach", "a person rides a horse"]},
     {0: ["a man riding a horse"]}),
    ({0: ["a man", "a horse"]}, {0: ["a man and a horse"]}),
    ({0: ["a man riding a horse"], 1: ["a red car"]},
     {0: ["a man riding a horse"], 1: ["a dog"]}),
    ({i: [c] for i, (c, _) in enumerate(SPICE_CASES)},
     {i: [SPICE_CASES[(i + 1) % len(SPICE_CASES)][0]]
      for i in range(len(SPICE_CASES))}),
]


def corpora():
    return [_corpus(50, seed=s) for s in (0, 3, 7)] + METEOR_SETS


def assert_scores_equal(got, want):
    g_score, g_per = got
    w_score, w_per = want
    assert np.asarray(g_score).tolist() == np.asarray(w_score).tolist()
    assert type(g_per) is type(w_per)
    g_per, w_per = np.asarray(g_per), np.asarray(w_per)
    assert g_per.dtype == w_per.dtype and g_per.shape == w_per.shape
    assert g_per.tolist() == w_per.tolist()


@pytest.mark.parametrize("name,make", [
    ("bleu", lambda m: m.Bleu(4)), ("rouge", lambda m: m.Rouge()),
    ("cider", lambda m: m.Cider())])
def test_ngram_metrics_match(name, make):
    for gts, res in corpora():
        assert_scores_equal(make(torch_metrics).compute_score(gts, res),
                            make(jax_metrics).compute_score(gts, res))


def test_native_meteor_matches():
    for gts, res in corpora():
        assert_scores_equal(
            torch_metrics.NativeMeteor().compute_score(gts, res),
            jax_metrics.NativeMeteor().compute_score(gts, res))
    got = torch_metrics.NativeMeteor().sentence_stats(
        "a big cat", ["a large feline", "the big cats"])
    want = jax_metrics.NativeMeteor().sentence_stats(
        "a big cat", ["a large feline", "the big cats"])
    assert got[0] == want[0] and list(got[1]) == list(want[1])


def test_native_meteor_paraphrase_table_matches(tmp_path):
    tab = tmp_path / "para.tsv"
    tab.write_text("big cat\tlarge feline\n")
    gts, res = {0: ["a large feline"]}, {0: ["a big cat"]}
    assert_scores_equal(
        torch_metrics.NativeMeteor(paraphrase_table=str(tab))
        .compute_score(gts, res),
        jax_metrics.NativeMeteor(paraphrase_table=str(tab))
        .compute_score(gts, res))


def test_native_spice_matches():
    for caption, _ in SPICE_CASES:
        assert (torch_spice.parse_scene_graph(caption)
                == jax_spice.parse_scene_graph(caption))
    for gts, res in SPICE_SETS + corpora()[:1]:
        assert_scores_equal(
            torch_metrics.NativeSpice().compute_score(gts, res),
            jax_metrics.NativeSpice().compute_score(gts, res))


@pytest.mark.parametrize("name", ["Meteor", "Spice"])
def test_jar_wrappers_report_unavailable(name, monkeypatch):
    """No jar configured: both packages raise ExternalMetricUnavailable
    (the eval CLI then scores natively); no jar is fetched."""
    monkeypatch.delenv("VSRCIC_%s_JAR" % name.upper(), raising=False)
    gts, res = {0: ["a cat"]}, {0: ["a cat"]}
    for pkg in (torch_metrics, jax_metrics):
        with pytest.raises(pkg.ExternalMetricUnavailable):
            getattr(pkg, name)().compute_score(gts, res)
