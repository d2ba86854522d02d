"""Transformer blocks for the S-level SSP planner, on plain tensors.

Counterpart of `vsrcic_tpu/models/transformer.py` (reference
models/transformer_modules.py, models/sort_modules.py), torch-layout params.
Numerics kept for parity with released checkpoints:

  * attention logits masked with -1e3 (not -inf)       (ref transformer_modules.py:47)
  * embeddings scaled by sqrt(d)                       (ref :202)
  * pre-LN layers with plain residual adds             (ref :321-344)
  * decoder "cross"-attention reuses the self-attention projection weights —
    the reference layer calls `self.attention` instead of
    `self.cross_attention` (ref sort_modules.py:87); released checkpoints
    were trained with this, so it is reproduced (the unused cross_attention
    params are still created for state-dict compatibility).

Dropout takes a rate and a `torch.Generator`; eval passes neither. Relative
position logits, the generic decoder layer and the label-smoothed loss are
not ported yet (training, or unused upstream).
"""
from __future__ import annotations

import math

import torch

from vsrcic_tpu_torch.core import nn

MASK_FILL = -1e3


# ---------------------------------------------------------------------------
# init helpers: xavier_uniform weights, torch-default biases
# (reference S_SSP.initialize_parameters applies xavier_uniform to every
#  param with dim > 1, leaving biases at their module defaults)
# ---------------------------------------------------------------------------

def _lin(gen, i, o, bias=True):
    p = nn.linear_init(gen, i, o, bias=bias)
    p["weight"] = nn.xavier_uniform(gen, (o, i))
    return p


def mha_init(gen, size):
    return {name: _lin(gen, size, size)
            for name in ("linear_Q", "linear_K", "linear_V", "linear_O")}


def _dropout(x, rate, rng):
    if rate > 0.0 and rng is not None:
        keep = torch.rand(x.shape, generator=rng, device=x.device) < 1 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)
    return x


def mha_apply(p, query, keys, values, mask=None, n_heads=8,
              dropout_rate=0.0, rng=None):
    """Multi-head attention (ref transformer_modules.py:106-134).

    mask: broadcastable to (B, heads, Tq, Tk); positions where mask == 0 get
    the logit MASK_FILL, after the 1/sqrt(head dim) scaling."""
    b, tq, size = query.shape
    hd = size // n_heads

    def split_heads(x):
        return x.reshape(x.shape[0], -1, n_heads, hd).transpose(1, 2)

    q = split_heads(nn.linear(p["linear_Q"], query))
    k = split_heads(nn.linear(p["linear_K"], keys))
    v = split_heads(nn.linear(p["linear_V"], values))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask == 0, MASK_FILL, logits)
    w = _dropout(torch.softmax(logits, dim=-1), dropout_rate, rng)
    ctx = (w @ v).transpose(1, 2).reshape(b, tq, size)
    return nn.linear(p["linear_O"], ctx)


def ff_init(gen, size, hidden):
    return {"w_1": _lin(gen, size, hidden), "w_2": _lin(gen, hidden, size)}


def ff_apply(p, x, dropout_rate=0.0, rng=None):
    h = torch.relu(nn.linear(p["w_1"], x))
    return nn.linear(p["w_2"], _dropout(h, dropout_rate, rng))


def encoder_layer_init(gen, size, ff_size):
    return {
        "attention": mha_init(gen, size),
        "ff_layer": ff_init(gen, size, ff_size),
        "layer_norm1": nn.layer_norm_init(size),
        "layer_norm2": nn.layer_norm_init(size),
    }


def encoder_layer_apply(p, x, mask=None, n_heads=8, dropout_rate=0.0,
                        rng=None):
    """Pre-LN self-attention + FF (ref transformer_modules.py:333-344)."""
    y1 = nn.layer_norm(p["layer_norm1"], x)
    y1 = mha_apply(p["attention"], y1, y1, y1, mask=mask, n_heads=n_heads,
                   dropout_rate=dropout_rate, rng=rng)
    y1 = _dropout(y1, dropout_rate, rng) + x
    y2 = nn.layer_norm(p["layer_norm2"], y1)
    y2 = ff_apply(p["ff_layer"], y2, dropout_rate=dropout_rate, rng=rng)
    return _dropout(y2, dropout_rate, rng) + y1


def decoder_layer_init(gen, size, ff_size):
    return {
        "attention": mha_init(gen, size),
        "cross_attention": mha_init(gen, size),  # unused in fwd (module doc)
        "ff_layer": ff_init(gen, size, ff_size),
        "layer_norm1": nn.layer_norm_init(size),
        "layer_norm2": nn.layer_norm_init(size),
        "layer_norm3": nn.layer_norm_init(size),
    }


def decoder_layer_apply(p, x, x_mask, y, y_mask=None, n_heads=8,
                        dropout_rate=0.0, rng=None):
    """Self-attn -> cross-attn -> FF (ref sort_modules.py:77-97).

    NB: cross-attention deliberately uses p["attention"] (see module doc).
    """
    h1 = nn.layer_norm(p["layer_norm1"], x)
    h1 = mha_apply(p["attention"], h1, h1, h1, mask=x_mask, n_heads=n_heads,
                   dropout_rate=dropout_rate, rng=rng)
    h1 = _dropout(h1, dropout_rate, rng) + x
    h2 = nn.layer_norm(p["layer_norm2"], h1)
    h2 = mha_apply(p["attention"], h2, y, y, mask=y_mask, n_heads=n_heads,
                   dropout_rate=dropout_rate, rng=rng)
    h2 = _dropout(h2, dropout_rate, rng) + h1
    h3 = nn.layer_norm(p["layer_norm3"], h2)
    h3 = ff_apply(p["ff_layer"], h3, dropout_rate=dropout_rate, rng=rng)
    return _dropout(h3, dropout_rate, rng) + h2


def positional_encoding(length, size, dtype=torch.float32, device="cpu"):
    """Sinusoidal table (ref transformer_modules.py:272-299)."""
    pos = torch.arange(length, dtype=dtype, device=device)[:, None]
    div = torch.exp(torch.arange(0, size, 2, dtype=dtype, device=device)
                    * -(math.log(10000.0) / size))
    pe = torch.zeros((length, size), dtype=dtype, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def transformer_embed(p, ids, size, positional=False, dropout_rate=0.0,
                      rng=None):
    """Scaled embedding lookup (ref transformer_modules.py:193-214)."""
    e = p["weight"][ids] * math.sqrt(size)
    if positional:
        e = e + positional_encoding(ids.shape[-1], size, e.dtype, e.device)
    return _dropout(e, dropout_rate, rng)
