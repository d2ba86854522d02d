"""The port's training-side transformer pieces against the JAX package's:
the label-smoothed KL loss, relative-position attention, the causal
temporal mask, the generic decoder layer (both `last_only` cases), and
dropout's law.

Tolerances: the loss within rtol 1e-6 (a sum of a few hundred f32 terms);
layer outputs within 1e-5 (the same math, summed in another order).
Dropout cannot match JAX's bits (one generator here, a key per sublayer
there), so its keep share and scale are checked instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.models import transformer as jt
from vsrcic_tpu_torch.models import transformer as tt
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp

T = torch.from_numpy


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_label_smoothing_kldiv_matches_jax():
    """Value within rtol 1e-6, and the gradient (-p, the smoothed target)
    within 1e-7, on masked rows among live ones."""
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 26).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(logits, -1))
    targets = rng.randint(0, 26, 40)
    mask = (rng.rand(40) < 0.7).astype(np.float32)
    want, g_want = jax.value_and_grad(jt.label_smoothing_kldiv)(
        jnp.asarray(logp), targets, mask, 26)
    lp = T(logp.copy()).requires_grad_(True)
    got = tt.label_smoothing_kldiv(lp, T(targets), T(mask), 26)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    (g_got,) = torch.autograd.grad(got, lp)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=0,
                               atol=1e-7)
    assert not g_got[torch.from_numpy(mask == 0)].any()


@pytest.fixture(scope="module")
def layers():
    """(JAX params, port params): a relative-position attention of width
    32 and a decoder layer of width 32 (ff 64)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    rel = jt.mha_init(k1, 32, relative_pos=True)
    dec = jt.decoder_layer_init(k2, 32, 64)
    j = {"rel": rel, "dec": dec}
    return j, params_from_jax(tp.to_numpy_tree(j))


@pytest.mark.parametrize("n_heads", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_relative_position_attention_matches_jax(layers, n_heads, masked):
    """Self-attention (Tq = Tk = 7, every relative offset up to the clip
    and beyond) and cross-attention (Tq 7, Tk 4) with the clipped
    relative-position logits, with and without a key mask."""
    j, t = layers
    rng = np.random.RandomState(n_heads)
    x = rng.randn(3, 7, 32).astype(np.float32)
    y = rng.randn(3, 4, 32).astype(np.float32)
    for keys in (x, y):
        mask = None
        if masked:
            mask = (rng.rand(3, 1, 7, keys.shape[1]) < 0.7).astype(np.float32)
        want = jt.mha_apply(j["rel"], x, keys, keys, mask, n_heads)
        got = tt.mha_apply(t["rel"], T(x), T(keys), T(keys),
                           None if mask is None else T(mask), n_heads)
        close(got, want)
    assert tuple(t["rel"]["relative_posmatrix"]["weight"].shape) == (5, 32)


def test_relative_position_init_matches_jax_tree():
    own = tt.mha_init(torch.Generator().manual_seed(0), 16, relative_pos=True)
    ref = tp.to_numpy_tree(jt.mha_init(jax.random.PRNGKey(0), 16,
                                       relative_pos=True))
    assert sorted(own) == sorted(ref)
    assert own["relative_posmatrix"]["weight"].shape == (5, 16)
    assert "relative_posmatrix" not in tt.mha_init(
        torch.Generator().manual_seed(0), 16)


def test_temporal_mask_matches_jax():
    for arg in (5, np.zeros((2, 6, 8), np.float32)):
        want = np.asarray(jt.temporal_mask(arg))
        got = tt.temporal_mask(arg if isinstance(arg, int) else T(arg))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32


@pytest.mark.parametrize("last_only", [False, True])
def test_generic_decoder_layer_matches_jax(layers, last_only):
    """The causal temporal mask on the full query, none on the last-only
    one; a source key mask; the cross-attention on p["attention"]."""
    j, t = layers
    rng = np.random.RandomState(7)
    enc = rng.randn(3, 5, 32).astype(np.float32)
    dec = rng.randn(3, 6, 32).astype(np.float32)
    src_mask = (rng.rand(3, 1, 1, 5) < 0.8).astype(np.float32)
    tgt = None if last_only else np.asarray(jt.temporal_mask(6))
    want = jt.generic_decoder_layer_apply(
        j["dec"], enc, dec, src_mask=src_mask, tgt_mask=tgt, n_heads=4,
        last_only=last_only)
    got = tt.generic_decoder_layer_apply(
        t["dec"], T(enc), T(dec), src_mask=T(src_mask),
        tgt_mask=None if tgt is None else T(tgt), n_heads=4,
        last_only=last_only)
    assert tuple(got.shape) == (3, 1 if last_only else 6, 32)
    close(got, want)


def test_dropout_keep_share_and_scale():
    """Keep share within 0.005 of 1 - rate over 200,000 draws, survivors
    exactly x / (1 - rate) in f32 (as JAX divides), the rest 0; the same
    seed draws the same mask, another seed another; no generator or rate 0
    is the identity."""
    x = torch.full((200_000,), 1.5)
    for rate in (0.1, 0.5):
        got = tt._dropout(x, rate, torch.Generator().manual_seed(0))
        kept = got != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) < 0.005
        torch.testing.assert_close(got[kept], (x / (1.0 - rate))[kept],
                                   rtol=0, atol=0)
        again = tt._dropout(x, rate, torch.Generator().manual_seed(0))
        assert torch.equal(got, again)
        other = tt._dropout(x, rate, torch.Generator().manual_seed(1))
        assert not torch.equal(got, other)
    assert tt._dropout(x, 0.1, None) is x
    assert tt._dropout(x, 0.0, torch.Generator()) is x
