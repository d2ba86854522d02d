"""The port's S-SSP planner (transformer blocks, encode/decode and the
constrained / greedy generates) against the JAX package's.

Tolerances: tokens identical; log-probabilities and layer outputs within
1e-5 (the same math, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.models import s_ssp as js
from vsrcic_tpu.models import transformer as jt
from vsrcic_tpu_torch.core import nn as tnn
from vsrcic_tpu_torch.models import s_ssp as ts
from vsrcic_tpu_torch.models import transformer as tt
from vsrcic_tpu_torch.utils.params import (flatten, params_from_jax,
                                           unflatten)

import torch_parity as tp

T = torch.from_numpy


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def small():
    """(JAX cfg, JAX params, port cfg, port params): hidden 32, 2 + 2."""
    cfg = tp.ssp_cfg("jax")
    params = js.init_ssp_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, tp.ssp_cfg("torch"), params_from_jax(
        tp.to_numpy_tree(params))


def planner_cases(seed, b, l=10):
    """Verb codes as floats (Flickr's 10000 * occurrence kept) and SR grids
    with the selection's edge cases in the first rows."""
    rng = np.random.RandomState(seed)
    det_sr = rng.randint(1, 26, (b, l)).astype(np.float64)
    det_sr[0, :] = 0              # empty multiset: inactive from step 0
    det_sr[1, 1:] = 0             # single role: finishes after one step
    det_sr[2, :] = det_sr[2, 0]   # all-duplicate roles: first max wins
    det_sr[3, 5:] = 0             # mid-length multiset
    det_sr[4, 2:6] = det_sr[4, 0]  # duplicates among distinct roles
    verb = (rng.randint(1, 2662, (b, 1))
            + 10000 * rng.randint(0, 3, (b, 1))).astype(np.float64)
    return verb, det_sr


def test_mha_and_layers_match_jax(small):
    cfg, params, _, tparams = small
    rng = np.random.RandomState(0)
    x = rng.randn(3, 6, 32).astype(np.float32)
    y = rng.randn(3, 4, 32).astype(np.float32)
    mask = (rng.rand(3, 1, 6, 6) < 0.7).astype(np.float32)
    mask[0, 0, 2] = 0.0           # a query with every key masked
    enc = params["encoder"]["encoder_layers"]["0"]
    dec = params["decoder"]["encoder_layers"]["1"]
    tenc = tparams["encoder"]["encoder_layers"]["0"]
    tdec = tparams["decoder"]["encoder_layers"]["1"]
    close(tt.mha_apply(tenc["attention"], T(x), T(x), T(x), T(mask), 8),
          jt.mha_apply(enc["attention"], x, x, x, mask, 8))
    close(tt.mha_apply(tenc["attention"], T(x), T(y), T(y), None, 4),
          jt.mha_apply(enc["attention"], x, y, y, None, 4))
    close(tt.encoder_layer_apply(tenc, T(x), T(mask), 8),
          jt.encoder_layer_apply(enc, x, mask, 8))
    close(tt.decoder_layer_apply(tdec, T(x), T(mask), T(y), None, 8),
          jt.decoder_layer_apply(dec, x, mask, y, None, 8))


def test_embed_and_positional_encoding_match_jax(small):
    _, params, _, tparams = small
    ids = np.array([[0, 3, 25, 7]], np.int32)
    close(tt.transformer_embed(tparams["sr_embed_layer"], T(ids), 32, True),
          jt.transformer_embed(params["sr_embed_layer"], ids, 32, True))
    close(tt.positional_encoding(11, 32), jt.positional_encoding(11, 32),
          atol=1e-6)


def test_encode_and_decode_match_jax(small):
    cfg, params, tcfg, tparams = small
    verb, det_sr = planner_cases(1, 6)
    prior = js.ssp_encode(params, cfg, verb, det_sr)
    tprior = ts.ssp_encode(tparams, tcfg, T(verb), T(det_sr))
    close(tprior, prior)
    tokens = np.zeros((6, 11), np.int32)
    tokens[:, 1:4] = det_sr[:, :3]
    tokens[2, 2:] = 0             # a finished row
    close(ts.ssp_decode(tparams, tcfg, T(tokens), tprior),
          js.ssp_decode(params, cfg, tokens, prior))


@pytest.mark.parametrize("mode", ["normal", "not-normal"])
@pytest.mark.parametrize("fast", [False, True])
def test_generate_matches_jax_small(small, fast, mode):
    cfg, params, tcfg, tparams = small
    jgen = js.ssp_generate_fast if fast else js.ssp_generate
    tgen = ts.ssp_generate_fast if fast else ts.ssp_generate
    verb, det_sr = planner_cases(2, 9)
    want = jax.jit(lambda v, d: jgen(params, cfg, v, d, mode=mode))(
        jnp.asarray(verb), jnp.asarray(det_sr))
    got = tgen(tparams, tcfg, T(verb), T(det_sr), mode=mode)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1], want[1])
    if mode != "normal":
        # the selection's edge cases, spelled out: the empty row emits
        # nothing, the duplicate row emits its one role ten times
        assert not got[0][0].any()
        assert (got[0][2] == int(det_sr[2, 0])).all()


@pytest.fixture(scope="module")
def full():
    """(JAX cfg, JAX params, port params) at the eval path's config: hidden
    512, 3 + 3 layers, 2662 verbs."""
    cfg = js.SSPConfig()
    params = js.init_ssp_params(jax.random.PRNGKey(4), cfg)
    return cfg, params, params_from_jax(tp.to_numpy_tree(params))


@pytest.mark.parametrize("fast", [False, True])
def test_generate_matches_jax_full_width(full, fast):
    """The eval path's config on a small batch, constrained as the pipeline
    runs it."""
    cfg, params, tparams = full
    jgen = js.ssp_generate_fast if fast else js.ssp_generate
    tgen = ts.ssp_generate_fast if fast else ts.ssp_generate
    verb, det_sr = planner_cases(3, 6)
    want = jgen(params, cfg, verb, det_sr, mode="not-normal")
    got = tgen(tparams, ts.SSPConfig(), T(verb), T(det_sr),
               mode="not-normal")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1], want[1])


@pytest.mark.parametrize("mode", ["normal", "not-normal"])
def test_fast_generate_matches_full_generate(small, mode):
    """The KV cache is exact: the port's fast generate gives its own full
    generate's tokens."""
    _, _, tcfg, tparams = small
    verb, det_sr = planner_cases(4, 16)
    full = ts.ssp_generate(tparams, tcfg, T(verb), T(det_sr), mode=mode)
    fast = ts.ssp_generate_fast(tparams, tcfg, T(verb), T(det_sr), mode=mode)
    np.testing.assert_array_equal(fast[0].numpy(), full[0].numpy())
    close(fast[1], full[1].numpy())


@pytest.mark.parametrize("fast", [False, True])
def test_truncated_loop_matches_full(small, fast):
    """n_steps >= the batch's largest slot count gives the full loop's
    output (the pipeline's even-bucketed truncation rests on it)."""
    _, _, tcfg, tparams = small
    gen = ts.ssp_generate_fast if fast else ts.ssp_generate
    verb, det_sr = planner_cases(5, 8)
    det_sr[:, 4:] = 0
    full = gen(tparams, tcfg, T(verb), T(det_sr), mode="not-normal")
    for n_steps in (4, 6):
        cut = gen(tparams, tcfg, T(verb), T(det_sr), mode="not-normal",
                  n_steps=n_steps)
        for g, w in zip(cut, full):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_first_argmax_picks_the_first_maximum():
    """The planner's selection rule, as jnp.argmax applies it."""
    x = np.array([[-np.inf, -np.inf, -np.inf],
                  [0.5, 2.0, 2.0],
                  [3.0, -np.inf, 3.0]], np.float32)
    idx = tnn.first_argmax(T(x))
    assert idx.tolist() == [0, 1, 0]
    assert idx.tolist() == np.asarray(jnp.argmax(x, -1)).tolist()


def test_weight_bridge_carries_the_ssp_tree(full):
    """params_from_jax keeps every leaf of the JAX tree, the unused
    cross_attention included, and the port's init builds the same tree."""
    jflat = flatten(tp.to_numpy_tree(full[1]))
    tflat = flatten(params_from_jax(unflatten(jflat)))
    own = flatten(ts.init_ssp_params(
        torch.Generator().manual_seed(0), ts.SSPConfig()))
    assert any(".cross_attention." in k for k in jflat)
    assert sorted(tflat) == sorted(jflat) == sorted(own)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), v, err_msg=k)
        assert tuple(own[k].shape) == v.shape, k
