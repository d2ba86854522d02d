"""The port's SCST trainer against the JAX package's, on the CPU, at the
sizes of tests/test_trainers.py: the SCST loss and every gradient leaf of a
given trajectory (remat on and off), the greedy baseline captions, the
advantage of JAX's sampled words and the grad step's loss; and both
baseline modes of `step` on the fast decode. The parameters are the
JAX-made ones of the trainers' golden fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.train import captioner as jtrain
from vsrcic_tpu_torch.train import captioner as ttrain
from vsrcic_tpu_torch.train import common as tcommon
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp


@pytest.fixture(scope="module")
def params():
    return tp.load_golden_train()[0]


@pytest.mark.parametrize("remat", [False, True])
def test_scst_loss_and_grads_match_jax(params, remat):
    det, grp, _ = tp.scst_batch()
    words, gates, adv = tp.scst_trajectory()
    loss_j, g_j = tp.jax_train_fns()["scst"](
        params, tp.train_cfg("jax"), jnp.asarray(det), jnp.asarray(grp),
        jnp.asarray(words, jnp.int32), jnp.asarray(gates, jnp.int32),
        jnp.asarray(adv), remat=remat)
    loss_t, g_t = tcommon.value_and_grad(
        ttrain.scst_loss_fn, params_from_jax(params), tp.train_cfg("torch"),
        torch.from_numpy(det), torch.from_numpy(grp), torch.from_numpy(words),
        torch.from_numpy(gates), torch.from_numpy(adv), remat=remat)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=tp.LOSS_RTOL)
    tp.assert_grads_match(g_t, g_j)


@pytest.fixture(scope="module")
def scst_pair(params):
    """(JAX trainer, port trainer) on the text world, strict decodes."""
    cfg_j = tp.train_cfg("jax")
    tf_j, cider_j = tp.text_world("jax")
    tf_t, cider_t = tp.text_world("torch")
    assert len(tf_t.vocab) == cfg_j.vocab_size
    jt = jtrain.CaptionerSCSTTrainer(cfg_j, params, tf_j, cider_j, lr=1e-4)
    tt = ttrain.CaptionerSCSTTrainer(tp.train_cfg("torch"), params, tf_t,
                                     cider_t, lr=1e-4, device="cpu")
    return jt, tt


def test_scst_baseline_advantage_and_grad_step_match_jax(scst_pair):
    """Greedy baseline captions equal JAX's; given JAX's sampled words, the
    advantage equals JAX's and the grad step's loss matches."""
    jt, tt = scst_pair
    det, grp, gts = tp.scst_batch()
    ((words, gates), _), base_j = jt._sample_and_greedy(
        jt.state.params, jnp.asarray(det), jnp.asarray(grp),
        jax.random.PRNGKey(3))
    base_caps = jt._decode_caps(base_j)
    assert tt.epoch_baseline_caps(det, grp) == base_caps
    _, base_t = tt.decode(torch.from_numpy(det), torch.from_numpy(grp))
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    sampled = jt._decode_caps(words)
    adv_j = jt.rewards(sampled, base_caps, gts)
    adv_t = tt.rewards(tt._decode_caps(torch.from_numpy(np.array(words))),
                       tt.epoch_baseline_caps(det, grp), gts)
    np.testing.assert_array_equal(adv_t, adv_j)
    loss_j, _ = tp.jax_train_fns()["scst"](
        jt.state.params, tp.train_cfg("jax"), jnp.asarray(det),
        jnp.asarray(grp), words, gates, jnp.asarray(adv_j), remat=True)
    loss_t = tt.grad_step(det, grp, np.array(words), np.array(gates),
                          adv_t)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=tp.LOSS_RTOL)
    assert tt.state.step == 1


def test_scst_step_and_epoch_baseline_run(params):
    """step() in both baseline modes, on the fast decode (the plain
    version of the fused op on the CPU) with bf16 tables: finite loss and
    advantage; epoch mode wants the snapshot."""
    tf, cider = tp.text_world("torch")
    det, grp, gts = tp.scst_batch()
    for baseline in ("step", "epoch"):
        tr = ttrain.CaptionerSCSTTrainer(
            tp.train_cfg("torch"), params_from_jax(params), tf,
            cider, baseline=baseline, fast_decode=True,
            table_dtype=torch.bfloat16, device="cpu")
        gen = torch.Generator().manual_seed(0)
        kw = {}
        if baseline == "epoch":
            with pytest.raises(ValueError, match="baseline_caps"):
                tr.step(det, grp, gts, gen)
            kw["baseline_caps"] = tr.epoch_baseline_caps(det, grp)
        loss, adv = tr.step(det, grp, gts, gen, **kw)
        assert np.isfinite(loss) and np.isfinite(adv)
        assert tr._fast.params is None      # decodes read the live params
