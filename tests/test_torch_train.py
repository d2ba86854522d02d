"""The port's XE trainer and Adam against the JAX package's, on the CPU,
at the sizes of tests/test_trainers.py: the XE losses and every gradient
leaf (dense, lean compact, compact expanded once), Adam against optax, and
the replay of the trainers' golden fixture that chip_smoke.py phase 9 makes
on the card. The parameters are the JAX-made ones of that fixture
(tests/test_torch_golden_train.py holds it to JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.train import common as jcommon
from vsrcic_tpu_torch.models.api import ControllableCaptioner
from vsrcic_tpu_torch.train import captioner as ttrain
from vsrcic_tpu_torch.train import common as tcommon
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp

@pytest.fixture(scope="module")
def params():
    return tp.load_golden_train()[0]


@pytest.fixture(scope="module")
def xe_batch():
    return tp.xe_batch()


def _xe_ctrl(kind, det, ids):
    """The control input of an XE path: dense groups, or compact ids."""
    return tp.dense_groups(det, ids) if kind == "dense" else ids


@pytest.mark.parametrize("kind,lean", [("dense", True), ("compact", True),
                                       ("compact", False)])
def test_xe_loss_and_grads_match_jax(params, xe_batch, kind, lean):
    det, caps, ids, gates = xe_batch
    ctrl = _xe_ctrl(kind, det, ids)
    (loss_j, aux_j), g_j = tp.jax_train_fns()["xe"](
        params, tp.train_cfg("jax"), jnp.asarray(det),
        jnp.asarray(caps, jnp.int32), jnp.asarray(ctrl), jnp.asarray(
            gates, jnp.int32), lean=lean)
    (loss_t, aux_t), g_t = tcommon.value_and_grad(
        ttrain.xe_loss_fn, params_from_jax(params), tp.train_cfg("torch"),
        torch.from_numpy(det), torch.from_numpy(caps), torch.from_numpy(ctrl),
        torch.from_numpy(gates), lean=lean, has_aux=True)
    for a, b in zip((loss_t,) + tuple(aux_t), (loss_j,) + tuple(aux_j)):
        np.testing.assert_allclose(float(a), float(b), rtol=tp.LOSS_RTOL)
    tp.assert_grads_match(g_t, g_j)


def test_xe_lean_equals_dense_in_the_port(params, xe_batch):
    """The lean compact loss is the dense loss: same value, same
    gradients."""
    det, caps, ids, gates = xe_batch
    outs = []
    for ctrl in (tp.dense_groups(det, ids), ids):
        outs.append(tcommon.value_and_grad(
            ttrain.xe_loss_fn, params_from_jax(params), tp.train_cfg("torch"),
            torch.from_numpy(det), torch.from_numpy(caps),
            torch.from_numpy(ctrl), torch.from_numpy(gates), has_aux=True))
    (l_d, _), g_d = outs[0]
    (l_c, _), g_c = outs[1]
    np.testing.assert_allclose(float(l_c), float(l_d), rtol=1e-6)
    for k, v in tp.flat_grads(g_d).items():
        np.testing.assert_allclose(tp.flat_grads(g_c)[k], v, rtol=2e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("grad_clip", [None, 0.05])
def test_adam_matches_optax(grad_clip):
    """Three steps with a learning-rate change between the second and the
    third, fed the same numpy gradients: parameters within 1e-7."""
    rng = np.random.RandomState(0)
    p0 = {"a": {"weight": rng.randn(7, 5).astype(np.float32)},
          "b": rng.randn(11).astype(np.float32)}
    grads = [{"a": {"weight": 0.1 * rng.randn(7, 5).astype(np.float32)},
              "b": 0.1 * rng.randn(11).astype(np.float32)}
             for _ in range(3)]
    grads[0]["b"][:3] = 0.0
    jtx = jcommon.adam(2e-3, grad_clip=grad_clip)
    jst = jcommon.init_train_state(jax.tree.map(jnp.asarray, p0), jtx)
    ttx = tcommon.adam(2e-3, grad_clip=grad_clip)
    tst = tcommon.init_train_state(params_from_jax(p0), ttx)
    for i, g in enumerate(grads):
        if i == 2:
            lr_state = jst.opt_state if grad_clip is None \
                else jst.opt_state[1]
            jcommon.set_learning_rate(lr_state, 7e-4)
            tcommon.set_learning_rate(tst.opt_state, 7e-4)
        jst = jcommon.apply_grads(jtx, jst, jax.tree.map(jnp.asarray, g))
        tst = tcommon.apply_grads(ttx, tst, params_from_jax(g))
        want = tp.flat_grads(jst.params)
        for k, v in tp.flat_grads(tst.params).items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-7,
                                       err_msg="step %d %s" % (i, k))
    assert tst.step == 3 and tst.opt_state.count == 3


def test_nll_loss_and_schedules_match_jax():
    rng = np.random.RandomState(1)
    lp = np.log(rng.dirichlet(np.ones(6), (5, 4))).astype(np.float32)
    tgt = rng.randint(-1, 6, size=(5, 4))
    for ignore in (None, -1):
        want = jcommon.nll_loss(jnp.asarray(lp), jnp.asarray(tgt),
                                ignore_index=ignore)
        got = tcommon.nll_loss(torch.from_numpy(lp), torch.from_numpy(tgt),
                               ignore_index=ignore)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for epoch in range(10):
        assert tcommon.step_lr(5e-4, epoch) == jcommon.step_lr(5e-4, epoch)
        assert (tcommon.planner_lr(5e-4, epoch)
                == jcommon.planner_lr(5e-4, epoch))


def test_trainers_refuse_what_is_not_ported(params):
    tf, cider = tp.text_world("torch")
    cfg = tp.train_cfg("torch")
    with pytest.raises(TypeError, match="DataMesh"):
        ttrain.CaptionerXETrainer(cfg, params, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="NativeCiderPair"):
        ttrain.CaptionerSCSTTrainer(cfg, params, tf, cider,
                                    native_cider=object(), device="cpu")
    with pytest.raises(ValueError, match="baseline"):
        ttrain.CaptionerSCSTTrainer(cfg, params, tf, cider, baseline="x",
                                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.CaptionerXETrainer(cfg, params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.CaptionerSCSTTrainer(cfg, params, tf, cider)


def test_golden_train_fixture_replays_on_cpu():
    """The replay chip_smoke.py makes on the card, here on the CPU."""
    params, g = tp.load_golden_train()
    cfg = tp.train_cfg("torch")
    xe = [g["xe/" + k] for k in ("detections", "captions", "ids", "gates")]
    tr = ttrain.CaptionerXETrainer(cfg, params, lr=float(g["lr"]),
                                   device="cpu")
    (_, _), grads = tr.loss_and_grads(*xe)
    want = {k[len("xe/grad/"):]: v for k, v in g.items()
            if k.startswith("xe/grad/")}
    for k, v in tp.flat_grads(grads).items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **tp.GRAD_TOL)
    losses = [tr.step(*xe)[0] for _ in range(3)]
    np.testing.assert_allclose(losses, g["xe/losses"], rtol=1e-4)
    assert losses[2] < losses[0]
    loss, grads = tcommon.value_and_grad(
        ttrain.scst_loss_fn, params_from_jax(params), cfg,
        *(torch.from_numpy(g["scst/" + k]) for k in (
            "detections", "groups", "words", "gates", "advantage")),
        remat=True)
    np.testing.assert_allclose(float(loss), g["scst/loss"], rtol=1e-4)
    want = {k[len("scst/grad/"):]: v for k, v in g.items()
            if k.startswith("scst/grad/")}
    for k, v in tp.flat_grads(grads).items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **tp.GRAD_TOL)
    for fused in (False, True):   # the fused op's plain version on the CPU
        cap = ControllableCaptioner(cfg, params=params, device="cpu",
                                    use_fused_attention=fused)
        words, gates = cap.test(g["scst/detections"], g["scst/groups"])
        np.testing.assert_array_equal(words.numpy(), g["greedy/words"])
        np.testing.assert_array_equal(gates.numpy(), g["greedy/gates"])
