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
from typing import Any, Dict

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


def orthogonal(gen: torch.Generator, shape, dtype=torch.float32):
    """torch.nn.init.orthogonal_ (gain 1) for a 2-D weight."""
    n_rows, n_cols = shape
    big = max(n_rows, n_cols)
    q, r = torch.linalg.qr(torch.randn((big, big), generator=gen,
                                       dtype=dtype))
    q = q * torch.sign(torch.diagonal(r))  # deterministic sign
    return q[:n_rows, :n_cols].contiguous()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(p: Params, x):
    y = x @ p["weight"].T
    if "bias" in p:
        y = y + p["bias"]
    return y


def embedding(p: Params, ids):
    return p["weight"][ids]


def lstm_cell(p: Params, x, state):
    """One LSTM step (torch gate packing i, f, g, o). state = (h, c)."""
    h, c = state
    gates = (x @ p["weight_ih"].T + p["bias_ih"] + h @ p["weight_hh"].T
             + p["bias_hh"])
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
