"""The port's Sinkhorn normalization and SinkhornNet against the JAX
package's.

The Pallas kernel (`scripts/ab_sinkhorn.py::sinkhorn_normalize_pallas`) has
no interpret-mode call in the JAX package, which held it against
`vsrcic_tpu.models.sinkhorn.sinkhorn_normalize`; the port's plain version is
held against that function here, and the CUDA kernel against the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
Tolerance: 1e-6 absolute, on outputs in [0, 1].
"""
import jax
import numpy as np
import pytest
import torch

from vsrcic_tpu.models import sinkhorn as jsk
from vsrcic_tpu_torch.models import sinkhorn as tsk
from vsrcic_tpu_torch.ops.sinkhorn import (sinkhorn_normalize,
                                           sinkhorn_normalize_in_order,
                                           sinkhorn_normalize_plain)
from vsrcic_tpu_torch.utils.params import params_from_jax

import torch_parity as tp


def sink_inputs(seed, s, n):
    """Scores as the net hands them to the normalization: tanh of an
    affine map, in (-1, 1)."""
    rng = np.random.RandomState(seed)
    return np.tanh(rng.randn(s, n, n)).astype(np.float32)


@pytest.mark.parametrize("n_iters,tau", [(20, 0.1), (5, 1.0), (1, 0.3)])
@pytest.mark.parametrize("s,n", [(1, 1), (7, 3), (64, 10), (5, 17),
                                 (3, 33)])
def test_plain_normalize_matches_jax(s, n, n_iters, tau):
    x = sink_inputs(s * 100 + n, s, n)
    want = np.asarray(jsk.sinkhorn_normalize(x, n_iters, tau))
    got = sinkhorn_normalize_plain(torch.from_numpy(x), n_iters, tau)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_kernel_sum_order_matches_jax():
    """The CUDA kernel's arithmetic, replayed step by step (the card's tests
    hold the kernel to this replay bit for bit), at the eval
    pipeline's shapes (1536 matrices, n = 10, 20 iterations, tau 0.1):
    within 1e-6 of JAX."""
    x = sink_inputs(11, 1536, 10)
    want = np.asarray(jsk.sinkhorn_normalize(x, 20, 0.1))
    got = sinkhorn_normalize_in_order(torch.from_numpy(x), 20, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    x = torch.from_numpy(sink_inputs(0, 9, 10))
    before = sinkhorn_normalize.launches
    got = sinkhorn_normalize(x, 20, 0.1)
    assert sinkhorn_normalize.launches == before
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, 20, 0.1),
                               rtol=0, atol=0)


def test_wrapper_raises_on_an_unsupported_device():
    with pytest.raises(ValueError, match="unsupported device"):
        sinkhorn_normalize(torch.zeros((2, 10, 10), device="meta"), 20, 0.1)


def test_zero_scores_normalize_to_uniform():
    """All-zero scores (a pipeline row of all-zero features still passes
    through the biases) give the same matrix in both packages: uniform up
    to EPS."""
    x = np.zeros((2, 10, 10), np.float32)
    want = np.asarray(jsk.sinkhorn_normalize(x, 20, 0.1))
    got = sinkhorn_normalize_plain(torch.from_numpy(x), 20, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, 0.1, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def nets():
    """(JAX apply, port params) per config: the reduced width of the
    pipeline tests and the reference's 2352-d slicing."""
    out = {}
    for name, kw in (("small", {}), ("full", dict(txt_dim=300, vis_dim=2048,
                                                  pos_dim=4))):
        jcfg, tcfg = tp.sink_cfg("jax", **kw), tp.sink_cfg("torch", **kw)
        params = jsk.init_sinkhorn_params(jax.random.PRNGKey(2), jcfg)
        out[name] = (jax.jit(lambda s, p=params, c=jcfg:
                             jsk.sinkhorn_net_apply(p, c, s)),
                     params_from_jax(tp.to_numpy_tree(params)), tcfg)
    return out


@pytest.mark.parametrize("width", ["small", "full"])
def test_sinkhorn_net_apply_matches_jax(nets, width):
    """Within 1e-6 at the pipeline tests' width. At the full 2352-d width
    the two packages' f32 MLPs (a 2048-long product among four layers)
    already differ by up to ~1e-6 before the normalization (each as far
    from an f64 evaluation), and exp(x / 0.1) carries that into the output:
    measured up to 1.5e-6 there, so the full width adds rtol 1e-5, as
    tests/test_sinkhorn_parity.py does for the reference net."""
    f, params, cfg = nets[width]
    rng = np.random.RandomState(5)
    seq = rng.rand(32, cfg.n, cfg.txt_dim + cfg.vis_dim + cfg.pos_dim)
    seq = seq.astype(np.float32)
    seq[3, 4:] = 0.0            # a pair's invalid rows, zeroed as gathered
    seq[7] = 0.0                # an all-zero input
    want = np.asarray(f(seq))
    got = tsk.sinkhorn_net_apply(params, cfg, torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5 if width == "full" else 0,
                               atol=1e-6)


def test_weight_bridge_carries_the_sinkhorn_tree():
    """params_from_jax keeps every key and value of the JAX tree, and the
    port's init builds the same tree (keys and shapes)."""
    cfg = tp.sink_cfg("jax", txt_dim=300, vis_dim=2048)
    jtree = tp.to_numpy_tree(jsk.init_sinkhorn_params(jax.random.PRNGKey(0),
                                                      cfg))
    ttree = params_from_jax(jtree)
    own = tsk.init_sinkhorn_params(torch.Generator().manual_seed(0),
                                   tp.sink_cfg("torch", txt_dim=300,
                                               vis_dim=2048))
    assert sorted(ttree) == sorted(jtree) == sorted(own)
    for k in jtree:
        assert sorted(ttree[k]) == sorted(jtree[k]) == sorted(own[k])
        for leaf in jtree[k]:
            np.testing.assert_array_equal(ttree[k][leaf].numpy(),
                                          jtree[k][leaf])
            assert tuple(own[k][leaf].shape) == jtree[k][leaf].shape
