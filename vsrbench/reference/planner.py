"""The two planners in plain PyTorch, float32.

S-SSP (reference `models/sort_model.py`, `models/sort_modules.py`,
`models/transformer_modules.py`): verb embedding + role embedding, a
pre-LN transformer encoder, a causal decoder whose second attention reuses
the self-attention weights (the reference layer calls `self.attention`
twice), attention logits masked with -1e3 after the 1/sqrt(head size)
scaling, embeddings scaled by sqrt(size). The decoder runs over the whole
token buffer (no cache).

The Sinkhorn network (reference `models/sinkhorn_network.py`): a row MLP
over the 2352-d (visual 2048, text 300, box 4) features, sliced [:300],
[300:2348], [2348:] as the reference slices them, then exp(x / tau) and
n_iters column and row normalisations with 1e-7 added to each sum.

`cfg` is the configuration file's `planner` or `sinkhorn` group.
"""
from __future__ import annotations

import math

import torch

MASK_FILL = -1e3
N_SR = 26
LN_EPS = 1e-5


def _lin(p, x):
    return x @ p["weight"].T + p["bias"]


def _ln(p, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["weight"] + p["bias"]


def _mha(p, q_in, kv_in, mask, n_heads):
    b, tq, size = q_in.shape
    hd = size // n_heads

    def heads(x):
        return x.reshape(b, -1, n_heads, hd).transpose(1, 2)

    q = heads(_lin(p["linear_Q"], q_in))
    k = heads(_lin(p["linear_K"], kv_in))
    v = heads(_lin(p["linear_V"], kv_in))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, MASK_FILL)
    ctx = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, tq, size)
    return _lin(p["linear_O"], ctx)


def _ff(p, x):
    return _lin(p["w_2"], torch.relu(_lin(p["w_1"], x)))


def _embed(p, ids, size):
    return p["weight"][ids] * math.sqrt(size)


def ssp_encode(p, cfg, verbs, det_sr):
    """verbs (G,) raw verb codes; det_sr (G, L) role ids -> (G, L, H)."""
    verbs = verbs.to(torch.int64) % 10000
    x = (_embed(p["v_embed_layer"], verbs[:, None], cfg["embed_size"])
         + _embed(p["sr_embed_layer"], det_sr.long(), cfg["embed_size"]))
    if cfg["add_fc"]:
        x = _lin(p["encoder"]["fc_feat"], x)
    for i in range(cfg["encoder_layers"]):
        lp = p["encoder"]["encoder_layers"][str(i)]
        y = _ln(lp["layer_norm1"], x)
        x = _mha(lp["attention"], y, y, None, cfg["n_heads"]) + x
        x = _ff(lp["ff_layer"], _ln(lp["layer_norm2"], x)) + x
    return _ln(p["encoder"]["layer_norm"], x)


def ssp_decode(p, cfg, tokens, prior):
    """Causal decoder over the token buffer (G, S) (position 0 is <bos> =
    0; token 0 keys are masked) -> log-probs over the roles (G, S, 26)."""
    s = tokens.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=tokens.device).tril()
    mask = (causal[None] & (tokens != 0)[:, None, :])[:, None]
    x = _embed(p["sr_embed_layer"], tokens.long(), cfg["embed_size"])
    for i in range(cfg["decoder_layers"]):
        lp = p["decoder"]["encoder_layers"][str(i)]
        y = _ln(lp["layer_norm1"], x)
        x = _mha(lp["attention"], y, y, mask, cfg["n_heads"]) + x
        x = _mha(lp["attention"], _ln(lp["layer_norm2"], x), prior, None,
                 cfg["n_heads"]) + x
        x = _ff(lp["ff_layer"], _ln(lp["layer_norm3"], x)) + x
    x = _ln(p["decoder"]["layer_norm"], x)
    return torch.log_softmax(_lin(p["expander_nn"], x), -1)


@torch.no_grad()
def judge_planner(p, cfg, verbs, det_sr, preds, lps):
    """How far the program's constrained role orders lie from this planner.

    The eval scripts' decode is greedy and constrained: step t emits the
    role of highest log-prob among the input slots not yet emitted. Here
    the served tokens are fed back (teacher forcing, one pass over the
    buffer; position 0 from a buffer of zeros, as a decode starts) and per
    group two gaps are taken, in nats: how far each served role's log-prob
    lies below the best role still open, and how far the program's
    recorded log-prob lies from this one. A served role that is not open,
    or a slot left unemitted, reads inf.

    verbs (G,), det_sr (G, L), preds (G, T) int, lps (G, T) f32 -> dict of
    (G,) tensors, and under "served_logps" (G, T) this planner's log-probs
    of the served roles (0 where a group has nothing open), in the
    program's record's form (the control reads them)."""
    g, t_len = preds.shape
    dev = det_sr.device
    prior = ssp_encode(p, cfg, verbs, det_sr)
    preds = preds.long()
    buf = torch.cat([torch.zeros((g, 1), dtype=torch.long, device=dev),
                     preds], 1)
    logp = ssp_decode(p, cfg, buf, prior)                       # (G, T+1, 26)
    logp0 = ssp_decode(p, cfg, buf[:, :1] * 0, prior)[:, 0]
    remain = det_sr != 0
    sel = torch.zeros((g,), device=dev)
    rec = torch.zeros((g,), device=dev)
    rows = torch.arange(g, device=dev)
    slot_ids = det_sr.long()
    own = []
    for t in range(t_len):
        lp_t = logp0 if t == 0 else logp[:, t]
        active = remain.any(1)
        scores = torch.where(remain, lp_t.gather(1, slot_ids), -math.inf)
        served = preds[:, t]
        is_open = remain & (slot_ids == served[:, None])
        ok = torch.where(active, is_open.any(1), served == 0)
        lp_served = lp_t.gather(1, served[:, None])[:, 0]
        gap = torch.where(active, scores.amax(1) - lp_served, 0.0)
        sel = torch.maximum(sel, torch.where(ok, gap, math.inf))
        rec = torch.maximum(rec, torch.where(
            active, (lps[:, t] - lp_served).abs(), lps[:, t].abs()))
        own.append(torch.where(active, lp_served, 0.0))
        first = torch.where(is_open.any(1), is_open.float().argmax(1), 0)
        remain[rows, first] &= ~(active & is_open.any(1))
    sel = torch.where(remain.any(1), math.inf, sel)
    return {"selection": sel, "record": rec,
            "served_logps": torch.stack(own, 1)}


def sinkhorn_net(p, cfg, seq):
    """seq (S, n, 2352) -> soft permutations (S, n, n)."""
    txt, vis = cfg["txt_dim"], cfg["vis_dim"]
    x_txt = torch.relu(_lin(p["W1_txt"], seq[:, :, :txt]))
    x_vis = torch.relu(_lin(p["W1_vis"], seq[:, :, txt:txt + vis]))
    x_vis = torch.relu(_lin(p["W2_vis"], x_vis))
    x = torch.cat([x_txt, x_vis, seq[:, :, txt + vis:]], -1)
    x = torch.tanh(_lin(p["W_fc"], torch.relu(_lin(p["W_fc_pos"], x))))
    v = torch.exp(x / cfg["tau"])
    for _ in range(cfg["n_iters"]):
        v = v / (1e-7 + v.sum(-2, keepdim=True))
        v = v / (1e-7 + v.sum(-1, keepdim=True))
    return v
