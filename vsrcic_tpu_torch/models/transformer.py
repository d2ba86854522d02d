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

Dropout takes a rate and a `torch.Generator`; eval passes neither. JAX
splits its key once per sublayer; here every sublayer draws from the one
generator, so masks follow the same law but not JAX's bits.

Also here, for training and for the reference's unused layers: the clipped
relative-position logits (`mha_init(..., relative_pos=True)`), the causal
`temporal_mask`, the generic decoder layer with its incremental `last_only`
query, and the sum-reduced label-smoothed KL divergence the planner trains
with.
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


RELATIVE_POS_CLIP = 2  # ref transformer_modules.py:73


def mha_init(gen, size, relative_pos=False):
    p = {name: _lin(gen, size, size)
         for name in ("linear_Q", "linear_K", "linear_V", "linear_O")}
    if relative_pos:
        p["relative_posmatrix"] = {"weight": nn.xavier_uniform(
            gen, (RELATIVE_POS_CLIP * 2 + 1, size))}
    return p


def _dropout(x, rate, rng):
    if rate > 0.0 and rng is not None:
        keep = nn.rand(rng, x.shape, x.device) < 1 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)
    return x


def mha_apply(p, query, keys, values, mask=None, n_heads=8,
              dropout_rate=0.0, rng=None):
    """Multi-head attention (ref transformer_modules.py:106-134).

    mask: broadcastable to (B, heads, Tq, Tk); positions where mask == 0 get
    the logit MASK_FILL, after the 1/sqrt(head dim) scaling. When p carries
    "relative_posmatrix" the clipped relative-position logits are added
    before the scaling and broadcast over heads, computed from the full
    (unsplit) transformed query (ref :103-115, KeyValAttention :39-42)."""
    b, tq, size = query.shape
    hd = size // n_heads

    def split_heads(x):
        return x.reshape(x.shape[0], -1, n_heads, hd).transpose(1, 2)

    tq_full = nn.linear(p["linear_Q"], query)                       # (B,Tq,H)
    q = split_heads(tq_full)
    k = split_heads(nn.linear(p["linear_K"], keys))
    v = split_heads(nn.linear(p["linear_V"], values))
    logits = q @ k.transpose(-1, -2)
    if "relative_posmatrix" in p:
        dev = query.device
        rel = (torch.arange(keys.shape[1], device=dev)[None, :]
               - torch.arange(tq, device=dev)[:, None]).clamp(
                   -RELATIVE_POS_CLIP, RELATIVE_POS_CLIP)
        rpe = p["relative_posmatrix"]["weight"][rel + RELATIVE_POS_CLIP]
        logits = logits + torch.einsum("bqh,qkh->bqk", tq_full, rpe)[:, None]
    logits = logits / math.sqrt(hd)
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


def temporal_mask(x_or_len, device="cpu"):
    """(1, T, T) causal mask, 1 below and on the diagonal (ref
    transformer_modules.py:247-269); takes an int length or an embedding
    (B, T, H), whose device it then uses."""
    if isinstance(x_or_len, int):
        t = x_or_len
    else:
        t, device = x_or_len.shape[-2], x_or_len.device
    return torch.tril(torch.ones((1, t, t), device=device))


def generic_decoder_layer_apply(p, encoder_states, decoder_states,
                                src_mask=None, tgt_mask=None, n_heads=8,
                                dropout_rate=0.0, rng=None, last_only=False):
    """The generic (upstream-unused) TransformerDecoderLayer (ref
    transformer_modules.py:347-386), with its quirks: cross-attention also
    uses p["attention"] (ref :378), and last_only=True takes the
    self-attention query from the final position alone (incremental
    decode, ref :364-368). Params: decoder_layer_init."""
    y1 = nn.layer_norm(p["layer_norm1"], decoder_states)
    if last_only:
        y1 = mha_apply(p["attention"], y1[:, -1:], y1, y1, mask=tgt_mask,
                       n_heads=n_heads, dropout_rate=dropout_rate, rng=rng)
        y1 = _dropout(y1, dropout_rate, rng) + decoder_states[:, -1:]
    else:
        y1 = mha_apply(p["attention"], y1, y1, y1, mask=tgt_mask,
                       n_heads=n_heads, dropout_rate=dropout_rate, rng=rng)
        y1 = _dropout(y1, dropout_rate, rng) + decoder_states
    y2 = nn.layer_norm(p["layer_norm2"], y1)
    y2 = mha_apply(p["attention"], y2, encoder_states, encoder_states,
                   mask=src_mask, n_heads=n_heads, dropout_rate=dropout_rate,
                   rng=rng)
    y2 = _dropout(y2, dropout_rate, rng) + y1
    y3 = nn.layer_norm(p["layer_norm3"], y2)
    y3 = ff_apply(p["ff_layer"], y3, dropout_rate=dropout_rate, rng=rng)
    return _dropout(y3, dropout_rate, rng) + y2


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


def label_smoothing_kldiv(log_probs, targets, mask, n_classes,
                          smoothing=0.1):
    """Sum-reduced KL divergence against the smoothed one-hot target (ref
    transformer_modules.py:150-179): sum p * (log p - log q) with
    0 log 0 := 0, each masked row's p all zero.

    log_probs: (N, C) model log-probs; targets: (N,) int; mask: (N,) {0,1}.
    p is a constant (built without a graph), so the gradient flows through
    -p * log_probs alone."""
    sval = smoothing / (n_classes - 2)
    conf = 1.0 - smoothing
    p = torch.full(log_probs.shape, sval, dtype=log_probs.dtype,
                   device=log_probs.device)
    p.scatter_(1, targets.long()[:, None], conf)
    p = torch.where((mask == 0)[:, None], 0.0, p)
    plogp = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0)
    return torch.sum(plogp - p * log_probs)
