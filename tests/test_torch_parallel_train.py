"""The port's trainers under a data-parallel mesh (`mesh=DataMesh`) on gloo
ranks on the CPU, at worlds 2 and 3 (one spawn of each world runs every
case; tests/torch_dist_workers.py holds the ranks' side), against the JAX
package's single-device steps, which tests/test_parallel.py holds equal to
its mesh steps:

  * XE on compact ids, 2 steps on a batch of 6: losses and parameters
    within rtol 1e-4 / atol 1e-6;
  * SCST's grad step on given trajectories for a batch of n + 1 (the pad
    path: repeated rows at advantage 0): loss and parameters likewise;
    the strict sampled decode of that batch gives the port's single-device
    trajectories from the same seed, token for token; a fast-decode step
    runs, each rank sampling from its own stream (seed * n + rank), whose
    draws' logprobs are the strict forced logprobs of its trajectories;
  * every rank ends with the same parameters, bit for bit.

The planner trainers' cases are in test_torch_parallel_planners.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vsrcic_tpu.train import captioner as jtrain
from vsrcic_tpu_torch.train import CaptionerSCSTTrainer
from vsrcic_tpu_torch.utils.params import flatten, params_from_jax

import torch_dist_workers as tdw
import torch_parity as tp

WORLDS = (2, 3)
XE_B, STEPS, LR, SEED = 6, 2, 1e-3, 5
TOL = dict(rtol=1e-4, atol=1e-6)


def xe_batch():
    rng = np.random.RandomState(1)
    v, t, d = (tp.TR_KW[k] for k in ("vocab_size", "seq_len",
                                     "det_feat_size"))
    dets = rng.rand(XE_B, tp.TR_N, d).astype(np.float32)
    dets[:, -1] = 0.0
    return (dets, rng.randint(0, v, (XE_B, t)).astype(np.int64),
            rng.randint(-1, tp.TR_N, (XE_B, t, tp.TR_M)).astype(np.int64),
            np.where(rng.rand(XE_B, t) < 0.2, -1,
                     rng.randint(0, 2, (XE_B, t))).astype(np.int64))


def scst_batch(b):
    """(detections, dense groups, GT captions, (words, gates, advantages))
    for b rows."""
    rng = np.random.RandomState(2)
    d, t = tp.TR_KW["det_feat_size"], tp.TR_KW["seq_len"]
    dets = rng.rand(b, tp.TR_N, d).astype(np.float32)
    groups = tp.dense_groups(dets, rng.randint(-1, tp.TR_N,
                                               (b, tp.TR_L, tp.TR_M)))
    gts = [" ".join(rng.choice(tp.WORDS, size=rng.randint(3, 7)))
           for _ in range(b)]
    traj = (rng.randint(0, tp.TR_KW["vocab_size"], (b, t)),
            rng.randint(0, 2, (b, t)), rng.randn(b).astype(np.float32))
    return dets, groups, gts, traj


@pytest.fixture(scope="module")
def params():
    return tp.load_golden_train()[0]


@pytest.fixture(scope="module", params=WORLDS, ids=["world2", "world3"])
def world(request, params, tmp_path_factory):
    n = request.param
    dets, groups, gts, traj = scst_batch(n + 1)
    cfg = dataclasses.asdict(tp.train_cfg("torch"))
    res = tdw.run_world(
        n, tmp_path_factory.mktemp("parallel_train"),
        xe=dict(cfg=cfg, params=params, batch=xe_batch(), lr=LR,
                steps=STEPS),
        scst=dict(cfg=cfg, params=params, words_vocab=tp.WORDS, dets=dets,
                  groups=groups, gts=gts, traj=traj, lr=LR, seed=SEED))
    return n, res


def flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def assert_params(rank, prefix, want):
    for k, v in flat_np(want).items():
        np.testing.assert_allclose(rank[prefix + k], v, err_msg=k, **TOL)


def assert_ranks_equal(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys
    for rank in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)


def test_xe_matches_jax(world, params):
    _, res = world
    tr = jtrain.CaptionerXETrainer(tp.train_cfg("jax"),
                                   jax.tree.map(jnp.asarray, params), lr=LR)
    want = [tr.step(*xe_batch()) for _ in range(STEPS)]
    for rank in res["xe"]:
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-4)
        assert_params(rank, "params/", tr.state.params)
    assert_ranks_equal(res["xe"], "params/")


@pytest.fixture(scope="module")
def text_worlds():
    return tp.text_world("jax"), tp.text_world("torch")


def test_scst_grad_step_matches_jax(world, params, text_worlds):
    """A batch of n + 1 pads n - 1 rows: repeats at advantage 0."""
    n, res = world
    dets, groups, _, (words, gates, adv) = scst_batch(n + 1)
    (tf, cider), _ = text_worlds
    tr = jtrain.CaptionerSCSTTrainer(
        tp.train_cfg("jax"), jax.tree.map(jnp.asarray, params),
        tf, cider, lr=LR)
    state, loss = tr._grad(tr.state, jnp.asarray(dets), jnp.asarray(groups),
                           jnp.asarray(words, jnp.int32),
                           jnp.asarray(gates, jnp.int32), jnp.asarray(adv))
    for rank in res["scst"]:
        np.testing.assert_allclose(rank["grad_loss"], float(loss), rtol=1e-4)
        assert_params(rank, "grad_params/", state.params)
    assert_ranks_equal(res["scst"], "grad_params/")


def test_scst_strict_samples_are_the_single_device_ones(world, params,
                                                        text_worlds):
    import torch
    n, res = world
    dets, groups, _, _ = scst_batch(n + 1)
    _, (tf, cider) = text_worlds
    one = CaptionerSCSTTrainer(tp.train_cfg("torch"),
                               params_from_jax(params), tf,
                               cider, lr=LR, device="cpu")
    ((w, g), (wl, gl)), base = one.decode(
        torch.from_numpy(dets), torch.from_numpy(groups),
        torch.Generator().manual_seed(SEED))
    for rank in res["scst"]:
        np.testing.assert_array_equal(rank["sampled/words"], w.numpy())
        np.testing.assert_array_equal(rank["sampled/gates"], g.numpy())
        np.testing.assert_array_equal(rank["sampled/greedy"], base.numpy())
        np.testing.assert_allclose(rank["sampled/word_logps"], wl.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["sampled/gate_logps"], gl.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_scst_fast_decode_steps_on_rank_streams(world, params):
    n, res = world
    seeds = [int(rank["fast/seed"]) for rank in res["scst"]]
    assert seeds == [SEED * n + r for r in range(n)]
    for rank in res["scst"]:
        assert np.isfinite(rank["fast/loss"])
        assert np.isfinite(rank["fast/adv"])
        for f in ("word_logps", "gate_logps"):
            np.testing.assert_allclose(rank["fast/" + f],
                                       rank["fast/forced_" + f],
                                       rtol=1e-5, atol=1e-6)
    assert_ranks_equal(res["scst"], "fast_params/")
    before = flat_np(params)
    assert any(not np.array_equal(res["scst"][0]["fast_params/" + k], v)
               for k, v in before.items())
