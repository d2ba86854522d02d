"""The port's Sinkhorn trainer against the JAX package's, on the CPU: the
pair builder, the trainer's loss and gradients under both normalisations
(at the pipeline tests' reduced width and at the reference's 2352-d),
three trainer steps, the gradient of the normalization's autograd
Function, and the eval pipeline's Sinkhorn call, which builds no graph.

Tolerances: losses within rtol 1e-5, gradients within rtol 1e-4 / atol
1e-6 at the reduced width (the captioner trainers' bars); at 2352-d an
atol of 1e-5 times a leaf's largest entry (torch_parity.grad_tol), since
the f32 round-off of both packages reaches ~2e-6 of it there, as
test_full_width_grads_f32_noise measures against float64; trainer losses
within rtol 1e-4 after Adam steps; the Function's gradient equal to plain
autograd's bit for bit (the same operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.train import planners as jplan
from vsrcic_tpu_torch.ops.sinkhorn import (sinkhorn_normalize,
                                           sinkhorn_normalize_grad,
                                           sinkhorn_normalize_plain)
from vsrcic_tpu_torch.train import planners as tplan
from vsrcic_tpu_torch.train.common import tree_map, value_and_grad
from vsrcic_tpu_torch.utils.params import flatten, params_from_jax

import torch_parity as tp

T = torch.from_numpy


def pair_grids(seed):
    """Nested grids (two images, two and one captions) with shared-SR
    slots, idx_list permutations and features of the reduced width."""
    rng = np.random.RandomState(seed)
    out = [[] for _ in range(7)]
    for n_caps in (2, 1):
        for g in out:
            g.append([])
        for _ in range(n_caps):
            job = tp.fuzz_job(rng)
            job["det_seqs_sr"][:, 0] = rng.randint(1, 4, tp.PL_L)
            il = np.full((tp.PL_L, 1), -1.0)
            il[:, 0] = rng.permutation(tp.PL_L)
            for g, x in zip(out, (job["control_verb"], job["det_seqs_v"],
                                  job["det_seqs_sr"], il, job["seqs_vis"],
                                  job["seqs_txt"], job["seqs_pos"])):
                g[-1].append(x)
    return out


def test_sinkhorn_pairs_from_grids_matches_jax():
    grids = pair_grids(0)
    want = jplan.sinkhorn_pairs_from_grids(*grids)
    got = tplan.sinkhorn_pairs_from_grids(*grids)
    assert want is not None and len(want[0]) >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert (got[1] == 10.0).any()          # the 10.0 padding
    empty = [[[x[0][0] * 0]] for x in grids]
    assert tplan.sinkhorn_pairs_from_grids(*empty) is None


@pytest.fixture(scope="module")
def nets():
    """Per width: (JAX params, the same as numpy, JAX cfg, port cfg)."""
    from vsrcic_tpu.models.sinkhorn import init_sinkhorn_params
    out = {}
    for name, kw in (("small", {}), ("full", dict(txt_dim=300, vis_dim=2048,
                                                  pos_dim=4))):
        jcfg, tcfg = tp.sink_cfg("jax", **kw), tp.sink_cfg("torch", **kw)
        params = init_sinkhorn_params(jax.random.PRNGKey(3), jcfg)
        out[name] = (params, tp.to_numpy_tree(params), jcfg, tcfg)
    return out


def batch_for(cfg, seed, n_pairs=5):
    return tp.sinkhorn_train_batch(
        seed, n_pairs, width=cfg.txt_dim + cfg.vis_dim + cfg.pos_dim)


@pytest.mark.parametrize("norm", ["images", "pairs"])
@pytest.mark.parametrize("width", ["small", "full"])
def test_sinkhorn_loss_and_grads_match_jax(nets, width, norm):
    params, np_params, jcfg, tcfg = nets[width]
    inputs, tr_locs, gt_locs = batch_for(jcfg, 1)
    denom = np.float32(3 if norm == "images" else len(inputs))
    loss_j, g_j = tp.jax_planner_fns()["sink"](
        params, jcfg, jnp.asarray(inputs), jnp.asarray(tr_locs),
        jnp.asarray(gt_locs), jnp.asarray(denom))
    tr = tplan.SinkhornTrainer(tcfg, np_params, loss_normalization=norm,
                               device="cpu")
    loss_t, g_t = tr.loss_and_grads(inputs, tr_locs, gt_locs, n_images=3)
    np.testing.assert_allclose(float(loss_t), float(loss_j),
                               rtol=tp.LOSS_RTOL)
    tp.assert_grads_match(g_t, g_j, scaled=width == "full")


def test_sinkhorn_trainer_steps_match_jax(nets):
    """Three Adam steps at lr 1e-3 (reduced width, 'images'): JAX's losses
    within rtol 1e-4, and they fall."""
    params, np_params, jcfg, tcfg = nets["small"]
    inputs, tr_locs, gt_locs = batch_for(jcfg, 2)
    jt = jplan.SinkhornTrainer(jcfg, params, lr=1e-3)
    tt = tplan.SinkhornTrainer(tcfg, np_params, lr=1e-3, device="cpu")
    want = [jt.step(inputs, tr_locs, gt_locs, n_images=3) for _ in range(3)]
    got = [tt.step(inputs, tr_locs, gt_locs, n_images=3) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_full_width_grads_f32_noise(nets):
    """At 2352-d, JAX's and the port's f32 gradients each lie within
    5e-6 times a leaf's largest entry (where that exceeds 1) of the port's
    float64 evaluation: the round-off for which the full-width parity
    scales its atol (torch_parity.grad_tol, 1e-5 times that entry)."""
    params, np_params, jcfg, tcfg = nets["full"]
    inputs, tr_locs, gt_locs = batch_for(jcfg, 1)
    _, g_j = tp.jax_planner_fns()["sink"](
        params, jcfg, jnp.asarray(inputs), jnp.asarray(tr_locs),
        jnp.asarray(gt_locs), jnp.asarray(np.float32(3)))
    grads = {}
    for dt in (torch.float32, torch.float64):
        p = tree_map(lambda x: x.to(dt), params_from_jax(np_params))
        _, grads[dt] = value_and_grad(
            tplan.sinkhorn_loss_fn, p, tcfg,
            *(T(a).to(dt) for a in (inputs, tr_locs, gt_locs)),
            torch.tensor(3.0, dtype=dt))
    ref = tp.flat_grads(grads[torch.float64])
    for got in (tp.flat_grads(grads[torch.float32]), tp.flat_grads(g_j)):
        for k, r in ref.items():
            np.testing.assert_allclose(
                got[k], r, rtol=0, err_msg=k,
                atol=5e-6 * max(1.0, float(np.abs(r).max())))


def test_autograd_function_gradient_equals_plain_autograd():
    """The Function (the wrapper forward, the plain version replayed
    backward) gives the same values and the same gradient bits as autograd
    through the plain version; on the CPU no kernel is launched."""
    rng = np.random.RandomState(0)
    x = np.tanh(rng.randn(37, 10, 10)).astype(np.float32)
    w = rng.randn(37, 10, 10).astype(np.float32)
    outs = []
    before = sinkhorn_normalize.launches
    for fn in (sinkhorn_normalize_grad, sinkhorn_normalize_plain):
        xt = T(x.copy()).requires_grad_(True)
        y = fn(xt, 20, 0.1)
        (g,) = torch.autograd.grad((y * T(w)).sum(), xt)
        outs.append((y.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert sinkhorn_normalize.launches == before
    with torch.no_grad():
        y = sinkhorn_normalize_grad(T(x).requires_grad_(True), 20, 0.1)
    assert y.grad_fn is None


def test_eval_pipeline_sinkhorn_builds_no_graph():
    """The pipeline's Sinkhorn call runs under no_grad: with every weight
    requiring a gradient, its soft permutations carry no graph."""
    from vsrcic_tpu_torch.pipelines import CaptionJob
    params, _, batches, _ = tp.load_golden_pipeline()
    pipe = tp.torch_pipeline(params)
    for leaf in flatten(pipe.sinkhorn_params).values():
        leaf.requires_grad_(True)
    jobs = tp.jobs_from(batches[0], CaptionJob)
    pend = pipe.plan_dispatch(jobs)
    assert pend.P_soft is not None and len(pend.P_soft)
    assert pend.P_soft.grad_fn is None and not pend.P_soft.requires_grad


def test_sinkhorn_trainer_refuses_what_it_cannot_take(nets):
    _, np_params, _, tcfg = nets["small"]
    with pytest.raises(NotImplementedError, match="mesh"):
        tplan.SinkhornTrainer(tcfg, np_params, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="loss_normalization"):
        tplan.SinkhornTrainer(tcfg, np_params, loss_normalization="x",
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tplan.SinkhornTrainer(tcfg, np_params)
