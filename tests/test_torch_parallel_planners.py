"""The port's planner trainers under a data-parallel mesh (`mesh=DataMesh`)
on gloo ranks on the CPU, at worlds 2 and 3 (one spawn of each world;
tests/torch_dist_workers.py holds the ranks' side), against the JAX
package's single-device steps, which tests/test_parallel.py holds equal to
its mesh steps: S-SSP on n + 3 groups (dropout off: weight-0 padded rows)
and Sinkhorn on n + 5 pairs (zero padded pairs) under both normalisations.

  * the gradient summed over the ranks at the first step is JAX's, within
    rtol 1e-4 / atol 1e-6 (the trainers' gradient bar);
  * the losses of 2 steps are within rtol 1e-4, and the parameters after
    them within rtol 1e-4 / atol 1e-6 wherever JAX's first gradient is
    above 1e-6. Where a gradient is round-off (S-SSP's attention key
    biases, whose gradient is zero in exact arithmetic), Adam's
    normalisation turns the round-off into a step of up to the learning
    rate, in either package and on any number of devices, so there the
    bar is 2 lr a step (tests/test_parallel.py allows rtol 5e-2 / atol
    1e-4 for the same reason);
  * every rank ends with the same parameters, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vsrcic_tpu.models.s_ssp import SSPConfig as JSSPConfig
from vsrcic_tpu.models.s_ssp import init_ssp_params
from vsrcic_tpu.models.sinkhorn import SinkhornConfig as JSinkConfig
from vsrcic_tpu.models.sinkhorn import init_sinkhorn_params
from vsrcic_tpu.train import planners as jplan
from vsrcic_tpu_torch.utils.params import flatten

import torch_dist_workers as tdw
import torch_parity as tp

WORLDS = (2, 3)
STEPS, LR = 2, 1e-3
SSP_KW = dict(hidden_size=16, embed_size=16, encoder_layers=1,
              decoder_layers=1, dropout=0.0)
SINK_KW = dict(n=4, n_iters=5, tau=0.1, txt_dim=6, vis_dim=8, pos_dim=2)
TOL = dict(rtol=1e-4, atol=1e-6)


def planner_batches(n):
    rng = np.random.RandomState(3 + n)
    g = n + 3
    ssp = (rng.randint(1, 50, (g, 1)).astype(np.float64),
           rng.randint(0, 5, (g, 10)).astype(np.float64),
           np.where(rng.rand(g, 10) < 0.6, rng.randint(1, 5, (g, 10)),
                    0).astype(np.float64))
    q = n + 5
    sink = (rng.rand(q, 4, 16).astype(np.float32),
            rng.rand(q, 4).astype(np.float32),
            rng.rand(q, 4).astype(np.float32), 4)
    return ssp, sink


@pytest.fixture(scope="module")
def params():
    return {"ssp": tp.to_numpy_tree(init_ssp_params(
                jax.random.PRNGKey(0), JSSPConfig(**SSP_KW))),
            "sinkhorn": tp.to_numpy_tree(init_sinkhorn_params(
                jax.random.PRNGKey(1), JSinkConfig(**SINK_KW)))}


@pytest.fixture(scope="module", params=WORLDS, ids=["world2", "world3"])
def world(request, params, tmp_path_factory):
    n = request.param
    ssp, sink = planner_batches(n)
    res = tdw.run_world(
        n, tmp_path_factory.mktemp("parallel_planners"),
        planners=dict(ssp_cfg=SSP_KW, ssp_params=params["ssp"],
                      ssp_batch=ssp, sink_cfg=SINK_KW,
                      sink_params=params["sinkhorn"], sink_batch=sink, lr=LR,
                      steps=STEPS))
    return n, res["planners"]


def flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def check(ranks, pre, losses, grads, state_params):
    grads, want = flat_np(grads), flat_np(state_params)
    for rank in ranks:
        np.testing.assert_allclose(rank[pre + "losses"], losses, rtol=1e-4)
        for k, g in grads.items():
            np.testing.assert_allclose(rank[pre + "grads/" + k], g,
                                       err_msg=k, **TOL)
            got, exp = rank[pre + "params/" + k], want[k]
            live = np.abs(g) > TOL["atol"]
            np.testing.assert_allclose(got[live], exp[live], err_msg=k,
                                       **TOL)
            np.testing.assert_allclose(got[~live], exp[~live], rtol=0,
                                       atol=2 * LR * STEPS, err_msg=k)
    for rank in ranks[1:]:
        for k in want:
            np.testing.assert_array_equal(rank[pre + "params/" + k],
                                          ranks[0][pre + "params/" + k])


def test_ssp_matches_jax(world, params):
    n, ranks = world
    (verbs, det_sr, gt_sr), _ = planner_batches(n)
    cfg = JSSPConfig(**SSP_KW)
    _, grads = tp.jax_planner_fns()["ssp"](
        params["ssp"], cfg, jnp.asarray(verbs), jnp.asarray(det_sr),
        jnp.asarray(gt_sr))
    tr = jplan.SSPTrainer(cfg, jax.tree.map(jnp.asarray, params["ssp"]),
                          lr=LR)
    losses = [tr.step(verbs, det_sr, gt_sr, jax.random.PRNGKey(i))
              for i in range(STEPS)]
    check(ranks, "ssp/", losses, grads, tr.state.params)


@pytest.mark.parametrize("norm", ["images", "pairs"])
def test_sinkhorn_matches_jax(world, params, norm):
    n, ranks = world
    _, (inputs, tr_locs, gt_locs, n_images) = planner_batches(n)
    cfg = JSinkConfig(**SINK_KW)
    denom = float(n_images if norm == "images" else len(inputs))
    _, grads = tp.jax_planner_fns()["sink"](
        params["sinkhorn"], cfg, jnp.asarray(inputs), jnp.asarray(tr_locs),
        jnp.asarray(gt_locs), jnp.asarray(denom))
    tr = jplan.SinkhornTrainer(cfg, jax.tree.map(jnp.asarray,
                                                 params["sinkhorn"]),
                               lr=LR, loss_normalization=norm)
    losses = [tr.step(inputs, tr_locs, gt_locs, n_images=n_images)
              for _ in range(STEPS)]
    check(ranks, "sink_%s/" % norm, losses, grads, tr.state.params)
