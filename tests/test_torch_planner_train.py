"""The port's S-SSP training pieces against the JAX package's, on the CPU,
in the eval pipeline tests' small planner (hidden 32, 2 + 2 layers, 2662
verbs): the teacher-forced loss and its gradients, the row-weight padding,
three SSPTrainer steps, the grid batcher, the beam search and the greedy
device assignment.

Tolerances: the loss within rtol 1e-5 and every gradient leaf within rtol
1e-4 / atol 1e-6 (the captioner trainers' bars); trainer losses within
rtol 1e-4 after Adam steps; tokens, batch arrays and assignments identical;
beam scores within 1e-5. Parity runs with dropout off (rng None, or rate
0 with a generator): the two packages draw different masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.models import s_ssp as js
from vsrcic_tpu.ops.assignment import greedy_assign_device as j_greedy
from vsrcic_tpu.train import planners as jplan
from vsrcic_tpu_torch.models import s_ssp as ts
from vsrcic_tpu_torch.ops.assignment import greedy_assign_device
from vsrcic_tpu_torch.train import planners as tplan
from vsrcic_tpu_torch.train.common import value_and_grad
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp

T = torch.from_numpy


@pytest.fixture(scope="module")
def world():
    """(JAX params, port params, jitted JAX value_and_grad of
    ssp_forward_loss): the small planner."""
    params = js.init_ssp_params(jax.random.PRNGKey(0), tp.ssp_cfg("jax"))
    vg = jax.jit(jax.value_and_grad(js.ssp_forward_loss), static_argnums=1)
    return params, params_from_jax(tp.to_numpy_tree(params)), vg


def test_forward_loss_and_grads_match_jax(world):
    """Loss and every gradient leaf. The attention key biases' gradients
    are 0 in exact arithmetic (a bias on every key of a row shifts its
    logits alike, which the softmax cancels); JAX's program gives exact
    zeros there and the port ~1e-10, inside the atol, so exact zeros are
    not required."""
    params, tparams, vg = world
    verbs, det_sr, gt_sr = tp.ssp_train_batch(0, 12)
    loss_j, g_j = vg(params, tp.ssp_cfg("jax"), jnp.asarray(verbs),
                     jnp.asarray(det_sr), jnp.asarray(gt_sr))
    loss_t, g_t = value_and_grad(ts.ssp_forward_loss, tparams,
                                 tp.ssp_cfg("torch"), T(verbs), T(det_sr),
                                 T(gt_sr))
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=tp.LOSS_RTOL)
    tp.assert_grads_match(g_t, g_j, exact_zeros=False)


def test_row_weights_padding_gives_the_unpadded_loss(world):
    """Zero rows appended with weight 0 leave the loss as it was: within
    1e-7 relative (a longer sum of the same nonzero terms), and, with the
    padded rows weighted 1, a different loss (position 0 counts)."""
    _, tparams, _ = world
    cfg = tp.ssp_cfg("torch")
    verbs, det_sr, gt_sr = tp.ssp_train_batch(1, 9)
    pad = lambda a: np.concatenate([a, np.zeros((3,) + a.shape[1:],  # noqa
                                                a.dtype)])
    base = ts.ssp_forward_loss(tparams, cfg, T(verbs), T(det_sr), T(gt_sr))
    w = torch.cat([torch.ones(9), torch.zeros(3)])
    padded = ts.ssp_forward_loss(tparams, cfg, T(pad(verbs)), T(pad(det_sr)),
                                 T(pad(gt_sr)), row_weights=w)
    np.testing.assert_allclose(float(padded), float(base), rtol=1e-7)
    ones = ts.ssp_forward_loss(tparams, cfg, T(pad(verbs)), T(pad(det_sr)),
                               T(pad(gt_sr)), row_weights=torch.ones(12))
    assert abs(float(ones) - float(base)) > 1e-4


def test_ssp_trainer_steps_match_jax(world):
    """Three Adam steps at lr 1e-3 with dropout 0: JAX's losses within rtol
    1e-4, and they fall."""
    params, _, _ = world
    kw = dict(tp.SSP_KW, dropout=0.0)
    verbs, det_sr, gt_sr = tp.ssp_train_batch(2, 10)
    jt = jplan.SSPTrainer(js.SSPConfig(**kw), params, lr=1e-3)
    tt = tplan.SSPTrainer(ts.SSPConfig(**kw), tp.to_numpy_tree(params),
                          lr=1e-3, device="cpu")
    want = [jt.step(verbs, det_sr, gt_sr, jax.random.PRNGKey(i))
            for i in range(3)]
    got = [tt.step(verbs, det_sr, gt_sr, torch.Generator().manual_seed(i))
           for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]
    tt.set_lr(5e-4)
    assert tt.state.opt_state.hyperparams["learning_rate"] == 5e-4


def test_dropout_loss_is_seeded(world):
    """With dropout 0.1: one seed gives one loss, another seed another, and
    no generator gives the dropout-free loss."""
    _, tparams, _ = world
    cfg = ts.SSPConfig(**dict(tp.SSP_KW, dropout=0.1))
    batch = [T(a) for a in tp.ssp_train_batch(3, 8)]
    loss = lambda seed: float(ts.ssp_forward_loss(  # noqa: E731
        tparams, cfg, *batch,
        rng=None if seed is None else torch.Generator().manual_seed(seed)))
    assert loss(5) == loss(5)
    assert loss(5) != loss(6)
    assert loss(None) == float(ts.ssp_forward_loss(
        tparams, ts.SSPConfig(**dict(tp.SSP_KW, dropout=0.0)), *batch))


def test_batch_from_grids_matches_jax():
    """The stacked (verbs, det_sr, gt_sr) of random nested grids (two
    images, two and one captions) equal JAX's; no groups gives None."""
    rng = np.random.RandomState(4)
    grids = [[], [], [], [], []]
    for n_caps in (2, 1):
        for g in grids:
            g.append([])
        for _ in range(n_caps):
            job = tp.fuzz_job(rng)
            gv = job["det_seqs_v"][rng.permutation(tp.PL_L)]
            gsr = job["det_seqs_sr"][rng.permutation(tp.PL_L)]
            for g, x in zip(grids, (job["control_verb"], job["det_seqs_v"],
                                    job["det_seqs_sr"], gv, gsr)):
                g[-1].append(x)
    want = jplan.SSPTrainer.batch_from_grids(*grids)
    got = tplan.SSPTrainer.batch_from_grids(*grids)
    assert want is not None and len(want[0]) > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    empty = [[[np.zeros(8)]], [[np.zeros((10, 8))]], [[np.zeros((10, 8))]],
             [[np.zeros((10, 8))]], [[np.zeros((10, 8))]]]
    assert tplan.SSPTrainer.batch_from_grids(*empty) is None


@pytest.mark.parametrize("beam", [1, 3])
def test_ssp_beam_search_matches_jax(world, beam):
    """Sequences identical, scores within 1e-5, on the selection's edge
    rows (an empty multiset, one role, duplicates)."""
    params, tparams, _ = world
    verb, det_sr = tp.ssp_beam_inputs()
    want = jax.jit(lambda v, d: js.ssp_beam_search(
        params, tp.ssp_cfg("jax"), v, d, beam_size=beam))(
            jnp.asarray(verb), jnp.asarray(det_sr))
    got = ts.ssp_beam_search(tparams, tp.ssp_cfg("torch"), T(verb),
                             T(det_sr), beam_size=beam)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("case", ["random", "ties", "soft_perm"])
def test_greedy_assign_device_matches_jax(case):
    for profit in tp.assignment_profits(case):
        want = np.asarray(jax.jit(j_greedy)(jnp.asarray(profit)))
        got = greedy_assign_device(T(profit))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got.tolist()) == list(range(profit.shape[0]))


def test_planner_trainers_refuse_what_is_not_ported(world):
    _, tparams, _ = world
    with pytest.raises(TypeError, match="DataMesh"):
        tplan.SSPTrainer(tp.ssp_cfg("torch"), tparams, mesh=object(),
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tplan.SSPTrainer(tp.ssp_cfg("torch"), tparams)
