"""The planner trainers' golden fixture (vsrcic_tpu_torch/testdata/
golden_planners.npz): it is what the JAX package computes today, and the
port replays it on the CPU as chip_smoke.py phase 11 does on the card.

Tolerances of the replay: losses within rtol 1e-5, the stored gradient
entries within rtol 1e-4 / atol 1e-6 (the captioner trainers' bars; for
the 2352-d Sinkhorn net an atol of 1e-5 times a leaf's largest entry, see
torch_parity.grad_tol), beam scores within 1e-5; beam sequences and
assignments identical.
"""
import json

import numpy as np
import pytest
import torch

from vsrcic_tpu_torch.models.s_ssp import SSPConfig, ssp_beam_search
from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
from vsrcic_tpu_torch.ops.assignment import greedy_assign_device
from vsrcic_tpu_torch.train.planners import SinkhornTrainer, SSPTrainer
from vsrcic_tpu_torch.utils.params import flatten

import torch_parity as tp


@pytest.fixture(scope="module")
def golden():
    return tp.load_golden_planners()


def test_golden_planners_fixture_is_current(golden):
    """Regenerating the fixture from JAX gives the committed arrays
    (rewrite it with `python tests/torch_parity.py --planners`): inputs,
    sequences and assignments exactly, losses, scores and gradients to
    1e-6 relative."""
    want = tp.planners_golden_arrays()
    assert sorted(golden) == sorted(want)
    for k in want:
        if "grad/" in k or "loss" in k or "scores" in k:
            np.testing.assert_allclose(golden[k], want[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(golden[k], want[k], err_msg=k)
    assert golden["sink/inputs"].dtype == np.float16


def stored_grads(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items()
            if k.startswith(prefix)}


def assert_sampled_grads(grads, want, cap, scaled=False):
    got = {k: tp.grad_sample(v.numpy(), cap)
           for k, v in flatten(grads).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k,
                                   **tp.grad_tol(w, scaled))


def test_golden_planners_replay_on_cpu(golden):
    cfg = json.loads(str(golden["config"]))
    params = tp.golden_planner_params()
    ssp = SSPTrainer(SSPConfig(**cfg["ssp"]), params["ssp"], device="cpu")
    loss, grads = ssp.loss_and_grads(golden["ssp/verbs"], golden["ssp/det_sr"],
                                     golden["ssp/gt_sr"])
    np.testing.assert_allclose(float(loss), golden["ssp/loss"],
                               rtol=tp.LOSS_RTOL)
    assert_sampled_grads(grads, stored_grads(golden, "ssp/grad/"),
                         cfg["grad_sample"])
    seqs, scores = ssp_beam_search(
        ssp.state.params, ssp.cfg, torch.from_numpy(golden["beam/verb"]),
        torch.from_numpy(golden["beam/det_sr"]), beam_size=cfg["beam_size"])
    np.testing.assert_array_equal(seqs.numpy(), golden["beam/seqs"])
    np.testing.assert_allclose(scores.numpy(), golden["beam/scores"], rtol=0,
                               atol=1e-5)
    inputs = golden["sink/inputs"].astype(np.float32)
    for norm in ("images", "pairs"):
        tr = SinkhornTrainer(SinkhornConfig(), params["sinkhorn"],
                             loss_normalization=norm, device="cpu")
        loss, grads = tr.loss_and_grads(inputs, golden["sink/tr_locs"],
                                        golden["sink/gt_locs"],
                                        cfg["n_images"])
        np.testing.assert_allclose(float(loss), golden["sink/%s/loss" % norm],
                                   rtol=tp.LOSS_RTOL)
        assert_sampled_grads(grads, stored_grads(golden, "sink/%s/grad/"
                                                 % norm), cfg["grad_sample"],
                             scaled=True)
    for profit, cols in zip(golden["assign/profits"], golden["assign/cols"]):
        np.testing.assert_array_equal(
            greedy_assign_device(torch.from_numpy(profit)).numpy(), cols)
