"""The port's native CIDEr-D scorer (vsrcic_tpu_torch/csrc/cider_scorer.cpp,
built here by the host C++ compiler) against the port's Python scorer and
the JAX package's native scorer; its rejection of what it does not
implement; the VSRCIC_NATIVE_CIDER knob; and the SCST trainer's reward
through it.

Tolerance: 1e-12 (float64; only the order of the terms' summation differs
from the Python scorer, none from the JAX package's C++ scorer)."""
import numpy as np
import pytest

from vsrcic_tpu.metrics import cider_native as j_native
from vsrcic_tpu.metrics.cider import Cider as JCider
from vsrcic_tpu_torch.metrics import cider_native
from vsrcic_tpu_torch.metrics.cider import Cider
from vsrcic_tpu_torch.ops import _build
from vsrcic_tpu_torch.train import captioner as ttrain

import torch_parity as tp

WORDS = ["a", "man", "dog", "rides", "red", "horse", "on", "the", "beach",
         "with", "cat", "runs", "small", "big"]


def corpus(rng, n, lo=3, hi=12):
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi)))
            for _ in range(n)]


def python_pair(cider, gt, gen, base):
    return cider.compute_score_pair({i: [g] for i, g in enumerate(gt)},
                                    {i: [c] for i, c in enumerate(gen)},
                                    {i: [c] for i, c in enumerate(base)})


def test_scorer_builds_from_the_port_source():
    """The library is built from csrc/cider_scorer.cpp (its stamp holds the
    hash of that source and the flags) into the port's build directory."""
    assert cider_native.available()
    lib = _build.host_library("cider_scorer")
    assert lib.parent == _build.BUILD and lib.exists()
    assert (_build.CSRC / "cider_scorer.cpp").exists()
    assert (lib.parent / (lib.name + ".sha")).read_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_python_and_jax_native(seed):
    rng = np.random.RandomState(seed)
    df = corpus(rng, 64)
    gt, gen, base = corpus(rng, 32), corpus(rng, 32), corpus(rng, 32)
    py = Cider(gts=df)
    r_py, rb_py = python_pair(py, gt, gen, base)
    r, rb = cider_native.NativeCiderPair(py).score_pair(gt, gen, base)
    np.testing.assert_allclose(r, r_py, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rb, rb_py, rtol=1e-12, atol=1e-12)
    assert j_native.available()
    r_j, rb_j = j_native.NativeCiderPair(JCider(gts=df)).score_pair(
        gt, gen, base)
    np.testing.assert_allclose(r, r_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rb, rb_j, rtol=1e-12, atol=1e-12)


def test_native_edge_cases():
    """Identical, disjoint (unseen words) and near-empty hypotheses."""
    py = Cider(gts=["a dog runs", "a cat sits"])
    nat = cider_native.NativeCiderPair(py)
    gt = ["a dog runs", "a cat sits"]
    gen = ["a dog runs", "entirely different words here"]
    base = ["a", "a cat sits"]
    r_py, rb_py = python_pair(py, gt, gen, base)
    r, rb = nat.score_pair(gt, gen, base)
    np.testing.assert_allclose(r, r_py, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rb, rb_py, rtol=1e-12, atol=1e-12)


def test_native_rejects_incompatible_cider():
    with pytest.raises(ValueError, match="corpus-df"):
        cider_native.NativeCiderPair(Cider())
    with pytest.raises(ValueError, match="sigma"):
        cider_native.NativeCiderPair(Cider(gts=["a b"], sigma=3.0))
    nat = cider_native.NativeCiderPair(Cider(gts=["a b c"]))
    with pytest.raises(ValueError, match="lengths differ"):
        nat.score_pair(["a b"], ["a"], ["a", "b"])


def test_maybe_native_knob(monkeypatch):
    """Knob on: the native scorer, or None for a Cider it does not
    implement; knob 0: None; knob on and a build that fails: raises."""
    py = Cider(gts=["a dog runs"])
    assert isinstance(cider_native.maybe_native(py, verbose=False),
                      cider_native.NativeCiderPair)
    assert cider_native.maybe_native(Cider(), verbose=False) is None
    monkeypatch.setenv("VSRCIC_NATIVE_CIDER", "0")
    assert cider_native.maybe_native(py, verbose=False) is None
    monkeypatch.setenv("VSRCIC_NATIVE_CIDER", "1")

    def broken(stem):
        raise RuntimeError("c++ failed (1): broken build")
    cider_native._load.cache_clear()
    monkeypatch.setattr(_build, "host_library", broken)
    try:
        with pytest.raises(RuntimeError, match="broken build"):
            cider_native.maybe_native(py, verbose=False)
        assert not cider_native.available()
    finally:
        cider_native._load.cache_clear()


def test_scst_rewards_equal_with_and_without_native():
    """The trainer's rewards through the native scorer equal those through
    the Python scorer (f32 advantages, the same bits here), on the
    trainers' text world; anything but a NativeCiderPair is refused."""
    tf, cider = tp.text_world("torch")
    params = tp.load_golden_train()[0]
    cfg = tp.train_cfg("torch")
    rng = np.random.RandomState(3)
    gts = tp.scst_batch()[2]
    sampled = [" ".join(rng.choice(tp.WORDS, rng.randint(1, 8)))
               for _ in gts]
    base = [" ".join(rng.choice(tp.WORDS, rng.randint(1, 8))) for _ in gts]
    out = []
    for nat in (None, cider_native.NativeCiderPair(cider)):
        tr = ttrain.CaptionerSCSTTrainer(cfg, params, tf, cider,
                                         native_cider=nat, device="cpu")
        out.append(tr.rewards(sampled, base, gts))
    assert out[0].dtype == out[1].dtype == np.float32
    np.testing.assert_array_equal(out[1], out[0])
    assert np.abs(out[0]).max() > 0
    with pytest.raises(TypeError, match="NativeCiderPair"):
        ttrain.CaptionerSCSTTrainer(cfg, params, tf, cider,
                                    native_cider=object(), device="cpu")
