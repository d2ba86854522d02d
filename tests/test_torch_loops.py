"""The port's decode loops and the facade's `forward` / `test` /
`sample_rl` against the JAX package's, on the CPU, at the sizes of
tests/test_trainers.py: group expansion from compact ids, teacher forcing
(dense and compact), greedy words and gates on the strict and the fused
path (JAX's fast path in interpret mode, the port's plain version of the
fused op), forced-trajectory logprobs with remat on and off, and sampling:
its logprobs are the forced ones of the drawn trajectory, and its draws
follow exp(logp). The parameters are the JAX-made ones of the trainers'
golden fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.decode import loops as jloops
from vsrcic_tpu.models import captioner as jcap
from vsrcic_tpu.models.api import ControllableCaptioner as JaxCaptioner
from vsrcic_tpu_torch.decode import loops as tloops
from vsrcic_tpu_torch.models import captioner as tcap
from vsrcic_tpu_torch.models.api import ControllableCaptioner
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp

TOL = dict(rtol=1e-5, atol=1e-5)
TABLES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def params():
    return tp.load_golden_train()[0]


@pytest.fixture(scope="module")
def jax_fns():
    """Jitted JAX programs shared by the module's tests."""
    cfg = tp.train_cfg("jax")

    def forced(p, det, grp, words, gates, remat):
        return jloops.forced_feedback_logprobs(
            p, cfg, jcap.precompute_statics(p, cfg, det, grp), words, gates,
            remat=remat)
    return dict(
        forced=jax.jit(forced, static_argnames=("remat",)),
        tf=jax.jit(lambda p, det, caps, ctrl: jloops.forward_teacher_forcing(
            p, cfg, det, caps, ctrl)),
        tf_compact=jax.jit(
            lambda p, det, caps, ids: jloops.forward_teacher_forcing_compact(
                p, cfg, det, caps, ids)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_expand_compact_groups_matches_jax():
    det, _, ids, _ = tp.xe_batch()
    want = np.asarray(jloops.expand_compact_groups(
        jnp.asarray(det), jnp.asarray(ids, jnp.int32)))
    got = tloops.expand_compact_groups(torch.from_numpy(det),
                                       torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, tp.dense_groups(det, ids))


@pytest.mark.parametrize("kind", ["dense", "compact"])
def test_forward_teacher_forcing_matches_jax(params, jax_fns, kind):
    det, caps, ids, _ = tp.xe_batch()
    jp = jax.tree.map(jnp.asarray, params)
    tparams = params_from_jax(params)
    cfg = tp.train_cfg("torch")
    if kind == "dense":
        grp = tp.dense_groups(det, ids)
        want = jax_fns["tf"](jp, jnp.asarray(det), jnp.asarray(caps, jnp.int32),
                             jnp.asarray(grp))
        got = ControllableCaptioner(cfg, params=tparams, device="cpu").forward(
            det, caps, grp)
    else:
        want = jax_fns["tf_compact"](jp, jnp.asarray(det), jnp.asarray(
            caps, jnp.int32), jnp.asarray(ids, jnp.int32))
        got = tloops.forward_teacher_forcing_compact(
            tparams, cfg, torch.from_numpy(det), torch.from_numpy(caps),
            torch.from_numpy(ids))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def _captioners(params, table):
    """(JAX, port) facades: strict, or the fused path with `table`
    storage (JAX's Pallas kernel in interpret mode)."""
    jp = jax.tree.map(jnp.asarray, params)
    if table is None:
        return (JaxCaptioner(tp.train_cfg("jax"), params=jp),
                ControllableCaptioner(tp.train_cfg("torch"),
                                      params=params_from_jax(params),
                                      device="cpu"))
    jdt, tdt = TABLES[table]
    return (JaxCaptioner(tp.train_cfg("jax"), params=jp,
                         use_fused_attention=True, table_dtype=jdt,
                         pallas_interpret=True),
            ControllableCaptioner(tp.train_cfg("torch"),
                                  params=params_from_jax(params),
                                  use_fused_attention=True, table_dtype=tdt,
                                  device="cpu"))


@pytest.mark.parametrize("table", [None, "f32", "bf16"])
def test_greedy_matches_jax(params, table):
    """Words and gates identical: strict against JAX's strict path, the
    fused path against JAX's fast path."""
    jc, tc = _captioners(params, table)
    det, grp, _ = tp.scst_batch()
    want = jc.test(det, grp)
    got = tc.test(det, grp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("remat", [False, True])
def test_forced_feedback_logprobs_match_jax(params, jax_fns, remat):
    det, grp, _ = tp.scst_batch()
    words, gates, _ = tp.scst_trajectory()
    want = jax_fns["forced"](jax.tree.map(jnp.asarray, params),
                             jnp.asarray(det), jnp.asarray(grp),
                             jnp.asarray(words, jnp.int32),
                             jnp.asarray(gates, jnp.int32), remat=remat)
    tparams = params_from_jax(params)
    cfg = tp.train_cfg("torch")
    statics = tcap.precompute_statics(tparams, cfg, torch.from_numpy(det),
                                      torch.from_numpy(grp))
    got = tloops.forced_feedback_logprobs(
        tparams, cfg, statics, torch.from_numpy(words),
        torch.from_numpy(gates), remat=remat)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("table", [None, "f32"])
def test_sampled_logprobs_are_the_forced_ones(params, jax_fns, table):
    """sample_rl's logprobs equal forced_feedback_logprobs of the drawn
    trajectory, the port's and JAX's, within 1e-5."""
    _, tc = _captioners(params, table)
    det, grp, _ = tp.scst_batch()
    gen = torch.Generator().manual_seed(5)
    (words, gates), lps = tc.sample_rl(det, grp, gen)
    assert words.shape == gates.shape == (tp.TR_B, tp.TR_KW["seq_len"])
    statics = tcap.precompute_statics(tc.params, tc.cfg,
                                      torch.from_numpy(det),
                                      torch.from_numpy(grp))
    forced = tloops.forced_feedback_logprobs(tc.params, tc.cfg, statics,
                                             words, gates)
    want = jax_fns["forced"](jax.tree.map(jnp.asarray, params),
                             jnp.asarray(det), jnp.asarray(grp),
                             jnp.asarray(words.numpy(), jnp.int32),
                             jnp.asarray(gates.numpy(), jnp.int32),
                             remat=False)
    for lp, f, w in zip(lps, forced, want):
        _close(lp, f.detach())
        _close(lp, w)


def test_categorical_draws_follow_the_softmax():
    """Gumbel-max draws of one row repeated 200000 times: each class's
    frequency within 5 standard errors of softmax(logits)."""
    logits = torch.log(torch.tensor([0.05, 0.5, 0.15, 0.3, 1e-4]))
    n = 200_000
    draws = tloops.categorical(torch.Generator().manual_seed(0),
                               logits.expand(n, -1))
    freq = torch.bincount(draws, minlength=5).double() / n
    p = torch.softmax(logits.double(), 0)
    assert torch.all((freq - p).abs() <= 5 * torch.sqrt(p * (1 - p) / n))


def test_sample_decode_first_words_follow_exp_logp(params):
    """One item repeated 20000 times: the first step's words and gates
    follow exp of the step's logprobs (chi-square over the vocabulary,
    far below its 0.1% critical value)."""
    n = 20_000
    det, grp, _ = tp.scst_batch()
    cfg = tp.train_cfg("torch")
    tparams = params_from_jax(params)
    rep = lambda a: torch.from_numpy(a[:1]).expand(  # noqa: E731
        (n,) + a.shape[1:]).contiguous()
    statics = tcap.precompute_statics(tparams, cfg, rep(det), rep(grp))
    (words, gates), (w_lp, g_lp) = tloops.sample_decode(
        tparams, cfg, statics, torch.Generator().manual_seed(1), seq_len=1)
    (w_logp, g_logp), _ = tcap.captioner_step(
        tparams, cfg, tcap.init_state(cfg, 1), tcap.precompute_statics(
            tparams, cfg, rep(det)[:1], rep(grp)[:1]),
        prev_word=torch.zeros(1, dtype=torch.long),
        prev_gate=torch.zeros(1, dtype=torch.long), t0=True)
    for draws, lp, logp, crit in (
            (words[:, 0], w_lp[:, 0], w_logp[0], 58.3),   # df 29
            (gates[:, 0], g_lp[:, 0], g_logp[0], 10.8)):  # df 1
        torch.testing.assert_close(lp, logp[draws], rtol=1e-5, atol=1e-5)
        p = torch.exp(logp.double())
        obs = torch.bincount(draws, minlength=p.numel()).double()
        chi2 = float(((obs - n * p) ** 2 / (n * p)).sum())
        assert chi2 < crit, chi2


def test_decodes_read_the_params_passed_in(params):
    """The facade derives its fused step weights from the params each
    decode passes in (a trainer's live weights), not from the params it
    was built with."""
    other = tcap.init_captioner_params(torch.Generator().manual_seed(7),
                                       tp.train_cfg("torch"))
    _, fast = _captioners(params, "f32")
    strict = ControllableCaptioner(tp.train_cfg("torch"), params=other,
                                   device="cpu")
    det, grp, _ = tp.scst_batch()
    got = fast._greedy_impl(other, torch.from_numpy(det),
                            torch.from_numpy(grp))
    want = strict.test(det, grp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(fast.test(det, grp)[0], want[0])
