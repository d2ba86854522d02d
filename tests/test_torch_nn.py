"""The port's nn primitives, ordering helpers and weight bridge against the
JAX package (`vsrcic_tpu.core.nn`), on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.core import nn as jnn
from vsrcic_tpu_torch.core import nn as tnn
from vsrcic_tpu_torch.utils.params import (flatten, params_from_jax,
                                           params_to_numpy, unflatten)

from torch_parity import jax_params, to_numpy_tree, torch_cfg


def _case(name, rng):
    """(params, args) of one primitive, as numpy."""
    if name == "linear":
        p = {"weight": rng.randn(7, 5), "bias": rng.randn(7)}
        return p, (rng.randn(3, 5),)
    if name == "embedding":
        return {"weight": rng.randn(11, 4)}, (rng.randint(0, 11, (3, 2)),)
    if name == "lstm_cell":
        h = 6
        p = {"weight_ih": rng.randn(4 * h, 5), "weight_hh": rng.randn(4 * h, h),
             "bias_ih": rng.randn(4 * h), "bias_hh": rng.randn(4 * h)}
        return p, (rng.randn(3, 5), (rng.randn(3, h), rng.randn(3, h)))
    p = {"weight": rng.randn(9), "bias": rng.randn(9)}
    return p, (3.0 * rng.randn(4, 9) + 1.0,)


def _f32(x):
    if isinstance(x, tuple):
        return tuple(_f32(v) for v in x)
    return x.astype(np.float32) if x.dtype.kind == "f" else x


@pytest.mark.parametrize("name", ["linear", "embedding", "lstm_cell",
                                  "layer_norm"])
def test_primitive_matches_jax(name):
    p, args = _case(name, np.random.RandomState(0))
    p, args = {k: _f32(v) for k, v in p.items()}, _f32(args)
    to_j = lambda a: tuple(to_j(v) for v in a) if isinstance(a, tuple) \
        else jnp.asarray(a)
    to_t = lambda a: tuple(to_t(v) for v in a) if isinstance(a, tuple) \
        else torch.from_numpy(a)
    want = getattr(jnn, name)({k: jnp.asarray(v) for k, v in p.items()},
                              *to_j(args))
    got = getattr(tnn, name)(params_from_jax(p), *to_t(args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_top_k_matches_lax_top_k_tie_order():
    """Lowest index first among equal values, -0.0 below +0.0, -inf last:
    jax.lax.top_k's order, which torch.topk does not promise."""
    rng = np.random.RandomState(1)
    x = rng.randn(6, 40).astype(np.float32)
    x[:, 10] = x[:, 3]                       # exact ties
    x[:, 20:25] = 5.0                        # a tie block at the top
    x[1] = -1e6                              # a whole row tied (verb sea)
    x[2, :4] = [0.0, -0.0, 0.0, -0.0]        # signed zeros
    x[2, 4:] = -1.0
    x[3, ::2] = -np.inf
    for k in (1, 5, 12):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tnn.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_weight_bridge_round_trip_and_init_layout():
    """params_from_jax / params_to_numpy / flatten are pure key mappings,
    and the port's initialiser makes the JAX tree's keys and shapes."""
    tree = to_numpy_tree(jax_params())
    back = params_to_numpy(params_from_jax(tree))
    flat_in, flat_back = flatten(tree), flatten(back)
    assert flat_in.keys() == flat_back.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_back[k], flat_in[k])
    assert flatten(unflatten(flat_in)).keys() == flat_in.keys()

    from vsrcic_tpu_torch.models.captioner import init_captioner_params
    mine = flatten(init_captioner_params(torch.Generator().manual_seed(0),
                                         torch_cfg()))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in flat_in.items()}
    r = torch_cfg().rnn_size
    w_hh = mine["lstm_cell_1.weight_hh"][:r]
    np.testing.assert_allclose((w_hh @ w_hh.T).numpy(), np.eye(r),
                               atol=1e-5)
