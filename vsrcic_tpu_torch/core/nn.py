"""NN primitives on plain tensors, with PyTorch's parameter layout.

Counterpart of `vsrcic_tpu.core.nn`. Parameters are nested dicts of tensors
whose layouts match torch's own modules (`Linear.weight` is ``(out, in)``,
``LSTMCell`` packs its gates i, f, g, o), so a JAX parameter tree maps onto
them by key alone (`vsrcic_tpu_torch.utils.params`).

Initialisers draw from a caller-owned `torch.Generator`; they follow the
distributions of the JAX initialisers, not their random stream.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (numerics match torch.nn.init)
# ---------------------------------------------------------------------------

def xavier_normal(gen: torch.Generator, shape, dtype=torch.float32):
    """torch.nn.init.xavier_normal_ for a 2-D ``(fan_out, fan_in)`` weight."""
    fan_out, fan_in = shape[0], math.prod(shape[1:])
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen, dtype=dtype)


def xavier_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    """torch.nn.init.xavier_uniform_ for a ``(fan_out, fan_in)`` weight."""
    fan_out, fan_in = shape[0], math.prod(shape[1:])
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, a, dtype)


def orthogonal(gen: torch.Generator, shape, dtype=torch.float32):
    """torch.nn.init.orthogonal_ (gain 1) for a 2-D weight."""
    n_rows, n_cols = shape
    big = max(n_rows, n_cols)
    q, r = torch.linalg.qr(torch.randn((big, big), generator=gen,
                                       dtype=dtype))
    q = q * torch.sign(torch.diagonal(r))  # deterministic sign
    return q[:n_rows, :n_cols].contiguous()


def _uniform(gen, shape, bound, dtype):
    """U(-bound, bound)."""
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1) * bound


def linear_init(gen: torch.Generator, in_features, out_features, bias=True,
                dtype=torch.float32) -> Params:
    """torch.nn.Linear's default init: weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    bound = math.sqrt(1.0 / in_features)
    p = {"weight": _uniform(gen, (out_features, in_features), bound, dtype)}
    if bias:
        p["bias"] = _uniform(gen, (out_features,), bound, dtype)
    return p


def layer_norm_init(size, dtype=torch.float32) -> Params:
    return {"weight": torch.ones((size,), dtype=dtype),
            "bias": torch.zeros((size,), dtype=dtype)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def matmul_t(x, w):
    """x @ w.T with jnp's type promotion: operands of two dtypes meet in
    the wider one (a bf16 weight and an f32 input: an f32 product of the
    exact upcast); two bf16 operands give a bf16 product."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w.T


def linear(p: Params, x):
    y = matmul_t(x, p["weight"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def embedding(p: Params, ids):
    return p["weight"][ids]


def lstm_cell(p: Params, x, state):
    """One LSTM step (torch gate packing i, f, g, o). state = (h, c)."""
    h, c = state
    gates = (matmul_t(x, p["weight_ih"]) + p["bias_ih"]
             + matmul_t(h, p["weight_hh"]) + p["bias_hh"])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def layer_norm(p: Params, x, eps=1e-5):
    """torch.nn.LayerNorm: biased variance, eps inside the square root."""
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["weight"] + p["bias"]


# ---------------------------------------------------------------------------
# Ordering (XLA's sort and top_k semantics)
# ---------------------------------------------------------------------------

def total_order_key(x):
    """int32 keys that order f32 values as XLA's sort comparator does
    (IEEE total order: -0.0 sorts below +0.0)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k(x, k: int):
    """`jax.lax.top_k` over the last axis: values descending, the lowest
    index first among equal values. `torch.topk` promises no tie order, so
    this is a stable sort of the bitwise-inverted total-order key."""
    idx = torch.sort(~total_order_key(x), dim=-1, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def first_argmax(x):
    """`jnp.argmax` over the last axis: the index of the FIRST maximum
    (`torch.argmax` promises no tie rule on the card); a row of all -inf
    gives 0."""
    mx = x.amax(-1, keepdim=True)
    pos = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == mx, pos, x.shape[-1]).amin(-1)


class BlockRNG(NamedTuple):
    """A generator standing for a rank's block of a data-parallel batch:
    a draw of shape (rows, ...) is rows lo..hi of the (n, ...) draw the
    whole batch would take from `gen`, rows past n repeating the last. So
    every rank's draws for its rows are those of the single-device run."""
    gen: torch.Generator
    lo: int
    hi: int
    n: int


def rand(rng, shape, device):
    """torch.rand(shape) from `rng`, a torch.Generator or a BlockRNG."""
    if not isinstance(rng, BlockRNG):
        return torch.rand(shape, generator=rng, device=device)
    u = torch.rand((rng.n,) + tuple(shape[1:]), generator=rng.gen,
                   device=device)
    return u[torch.arange(rng.lo, rng.hi, device=device).clamp_max(rng.n - 1)]
