"""The port's captioner step math against the JAX package, on the CPU:
statics, the dense step with verb substitution and the candidate step, on
the strict and the fused (hoisted image projection + fused attention) path,
with verb rows, gt mode and an empty tense list."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.models import captioner as jcap
from vsrcic_tpu.ops.vocab_topk import vocab_topk_lse_xla
from vsrcic_tpu_torch.models import captioner as tcap
from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse_plain

import torch_parity as tp

BEAM = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    return tp.to_numpy_tree(tp.jax_params())


def _pair(params, gt, fused):
    """(jax captioner, port captioner, JAX's statics/fused_fn/fused_w,
    the port's statics/route)."""
    jc = tp.jax_captioner(params, "f32" if fused else None)
    tc = tp.torch_captioner(params, "f32" if fused else None)
    det, groups, verb_list = tp.inputs(7, gt)
    js = jc._fused_statics(jc.params, jnp.asarray(det), jnp.asarray(groups),
                           jnp.asarray(verb_list).astype(jnp.int32),
                           beam=BEAM)
    ts = tc._route(tc.params, torch.from_numpy(det),
                   torch.from_numpy(groups), torch.from_numpy(verb_list))
    return jc, tc, js, ts


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _feedback(step_j, step_t, jc, tc, js, ts, **kw):
    """Run t0 and two feedback steps through both packages; yield each
    step's outputs. Words and gates fed back are fixed, so that every row
    moves its ctrl pointer and some rows hit verbs."""
    rows = tp.B * BEAM
    sj = jcap.init_state(jc.cfg, rows)
    st = tcap.init_state(tc.cfg, rows)
    rng = np.random.RandomState(3)
    for t in range(3):
        pw = rng.randint(0, tp.V, rows)
        pg = rng.randint(0, 2, rows)
        oj, sj = step_j(jc.params, jc.cfg, sj, js[0], prev_word=jnp.asarray(
            pw, jnp.int32), prev_gate=jnp.asarray(pg, jnp.int32), t0=t == 0,
            beam=BEAM, fused_fn=js[1], fused_w=js[2], **kw)
        ot, st = step_t(tc.params, tc.cfg, st, ts[0], prev_word=torch.from_numpy(
            pw), prev_gate=torch.from_numpy(pg), t0=t == 0, beam=BEAM,
            route=ts[1], **kw)
        for a, b in zip(st, sj):
            _close(a, b)
        yield oj, ot


def test_precompute_statics_and_fused_weights(params):
    jc, tc, js, ts = _pair(params, False, True)
    det, groups, verb_list = tp.inputs(7)
    want = jcap.precompute_statics(jc.params, jc.cfg, jnp.asarray(det),
                                   jnp.asarray(groups))
    got = tcap.precompute_statics(tc.params, tc.cfg, torch.from_numpy(det),
                                  torch.from_numpy(groups))
    for f in ("image_descriptor", "det_groups", "det_groups_proj",
              "det_groups_mask"):
        _close(getattr(got, f), getattr(want, f))
    _close(ts[0].img_y, js[0].img_y)
    for name in ("bx", "wh", "bh", "wx_img", "wx_nimg"):
        np.testing.assert_array_equal(ts[1].products.fused[name].numpy(),
                                      np.asarray(js[2][name]))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gt", [False, True])
def test_captioner_step_v_matches_jax(params, gt, fused):
    jc, tc, js, ts = _pair(params, gt, fused)
    for (wj, gj), (wt, gtt) in _feedback(
            lambda *a, **k: jcap.captioner_step_v(
                *a[:4], jc.tense_table, *a[4:], gt=gt, **k),
            lambda *a, **k: tcap.captioner_step_v(
                *a[:4], tc.tense_table, *a[4:], gt=gt, **k),
            jc, tc, js, ts):
        _close(wt, wj)
        _close(gtt, gj)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gt", [False, True])
def test_captioner_step_v_topk_matches_jax(params, gt, fused):
    jc, tc, js, ts = _pair(params, gt, fused)
    k = 5
    w = np.asarray(jc.params["out_fc"]["weight"])
    jtab = (jnp.asarray(w.T), jc.params["out_fc"]["bias"])
    ttab = (torch.from_numpy(np.ascontiguousarray(w.T)),
            tc.params["out_fc"]["bias"])
    jfn = lambda h2, w_t, b: vocab_topk_lse_xla(h2, w_t, b, k)
    tfn = lambda h2, w_t, b: vocab_topk_lse_plain(h2, w_t, b, k)
    outs = _feedback(
        lambda *a, **kw: jcap.captioner_step_v_topk(
            *a[:4], jc.tense_table, jfn, jtab, *a[4:], gt=gt, k=k, **kw),
        lambda *a, **kw: tcap.captioner_step_v_topk(
            *a[:4], tc.tense_table, tfn, ttab, *a[4:], gt=gt, k=k, **kw),
        jc, tc, js, ts)
    n_verb = 0
    for (ij, wj, gj), (it, wt, gtt) in outs:
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        _close(wt, wj)
        _close(gtt, gj)
        n_verb += int((np.asarray(wj)[:, 0] == 0).sum())
    assert n_verb > 0  # verb rows were exercised


def test_captioner_step_matches_jax(params):
    """The step of beam_search (no verb substitution), strict and fused."""
    for fused in (False, True):
        jc, tc, js, ts = _pair(params, False, fused)
        for (wj, gj), (wt, gtt) in _feedback(
                jcap.captioner_step, tcap.captioner_step, jc, tc, js, ts):
            _close(wt, wj)
            _close(gtt, gj)


def test_substitute_verb_empty_tense_list_and_gt():
    """Pred mode: the best valid tense (first maximum), word 0 for a verb
    with no tenses; gt mode: the given word; -1e6 sea and [-1e3, 0] gate."""
    rng = np.random.RandomState(4)
    wl = np.log(rng.dirichlet(np.ones(tp.V), 6)).astype(np.float32)
    wl[0, [5, 9, 11]] = wl[0, 9]  # tied tenses: first one wins
    gl = np.log(rng.dirichlet(np.ones(2), 6)).astype(np.float32)
    verb = np.array([1, 2, 3, -1, 1, 0])
    jt = jcap.VerbTenseTable(jnp.asarray(
        [[-1, -1, -1], [5, 9, 11], [7, -1, -1], [-1, -1, -1]], jnp.int32))
    tt = tcap.VerbTenseTable(torch.from_numpy(np.array(jt.ids)).long())
    for gt in (False, True):
        want = jcap.substitute_verb(jnp.asarray(wl), jnp.asarray(gl),
                                    jnp.asarray(verb, jnp.int32), jt, gt)
        got = tcap.substitute_verb(torch.from_numpy(wl), torch.from_numpy(gl),
                                   torch.from_numpy(verb), tt, gt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
