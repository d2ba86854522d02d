"""S-level SSP: verb-conditioned semantic-role sequence planner.

Counterpart of `vsrcic_tpu/models/s_ssp.py` (reference models/sort_model.py:
13-183): a 3-layer transformer encoder over (verb-embedding + SR-token)
inputs and a 3-layer causal decoder that emits the role order, trained with
the label-smoothed KL divergence (`ssp_forward_loss`).

Generation runs over a fixed-size token buffer (causal + pad masking make
the suffix inert), and the constrained selection is a batched masked argmax
over the remaining input slots: first max wins, slot-order ties as in the
reference's `masked_select`. JAX's `lax.scan` is a Python loop here.
Dropout is on only when a `torch.Generator` is passed as `rng` (on the
tensors' device); every sublayer draws from it in turn.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from vsrcic_tpu_torch.core import nn
from vsrcic_tpu_torch.models import transformer as tfm

N_SR = 26  # semantic-role vocab (25 roles + pad/eos 0), ref field.py:187-189


@dataclasses.dataclass(frozen=True)
class SSPConfig:
    dataset: str = "coco"
    encoder_layers: int = 3
    decoder_layers: int = 3
    max_len: int = 10
    hidden_size: int = 512
    embed_size: int = 512
    n_heads: int = 8
    pos_enc: bool = False
    add_fc: bool = True
    dropout: float = 0.1

    @property
    def verb_size(self) -> int:
        return 2662 if self.dataset == "coco" else 2926  # ref sort_model.py:19-22

    @property
    def ff_size(self) -> int:
        return self.hidden_size * 4


def init_ssp_params(gen: torch.Generator, cfg: SSPConfig) -> Dict[str, Any]:
    """Random parameters in the JAX tree's layout (tensors on the CPU)."""
    h = cfg.hidden_size
    params = {
        "sr_embed_layer": {"weight": nn.xavier_uniform(
            gen, (N_SR, cfg.embed_size))},
        "v_embed_layer": {"weight": nn.xavier_uniform(
            gen, (cfg.verb_size + 1, cfg.embed_size))},
        "encoder": {"layer_norm": nn.layer_norm_init(h), "encoder_layers": {
            str(i): tfm.encoder_layer_init(gen, h, cfg.ff_size)
            for i in range(cfg.encoder_layers)}},
        "decoder": {"layer_norm": nn.layer_norm_init(h), "encoder_layers": {
            str(i): tfm.decoder_layer_init(gen, h, cfg.ff_size)
            for i in range(cfg.decoder_layers)}},
        "expander_nn": tfm._lin(gen, h, N_SR),
    }
    if cfg.add_fc:
        params["encoder"]["fc_feat"] = tfm._lin(gen, h, h)
    return params


def ssp_encode(params, cfg: SSPConfig, verb, det_sr, rng=None):
    """Encoder (ref sort_modules.py:49-60). verb: (B,) or (B, 1), raw codes
    (float: Flickr keeps 10000 * occurrence), truncated to int32 and taken
    modulo 10000; det_sr: (B, L). rng: dropout at cfg.dropout, or None."""
    rate = cfg.dropout if rng is not None else 0.0
    verb = verb.to(torch.int32) % 10000
    if verb.dim() == 1:
        verb = verb[:, None]
    det_sr = det_sr.to(torch.int32)
    v = tfm.transformer_embed(params["v_embed_layer"], verb, cfg.embed_size,
                              dropout_rate=rate, rng=rng)
    s = tfm.transformer_embed(params["sr_embed_layer"], det_sr,
                              cfg.embed_size, positional=cfg.pos_enc,
                              dropout_rate=rate, rng=rng)
    x = v + s
    if cfg.add_fc:
        x = nn.linear(params["encoder"]["fc_feat"], x)
    for i in range(cfg.encoder_layers):
        x = tfm.encoder_layer_apply(
            params["encoder"]["encoder_layers"][str(i)], x, mask=None,
            n_heads=cfg.n_heads, dropout_rate=rate, rng=rng)
    return nn.layer_norm(params["encoder"]["layer_norm"], x)


def ssp_decode(params, cfg: SSPConfig, tokens, prior_states, rng=None):
    """Causal decoder over SR tokens (ref sort_modules.py:119-134).

    tokens: (B, S) int — position 0 is <bos>=0; pad is 0. The self-attention
    mask blocks future positions and token==0 keys (reference semantics).
    rng: dropout at cfg.dropout, or None.
    """
    rate = cfg.dropout if rng is not None else 0.0
    s = tokens.shape[1]
    length_mask = (tokens == 0)[:, None, :].float()                 # (B,1,S)
    triu = torch.triu(torch.ones((s, s), device=tokens.device), 1)[None]
    self_mask = ((triu + length_mask) == 0)[:, None]                # (B,1,S,S)
    x = tfm.transformer_embed(params["sr_embed_layer"], tokens,
                              cfg.embed_size, dropout_rate=rate, rng=rng)
    for i in range(cfg.decoder_layers):
        x = tfm.decoder_layer_apply(
            params["decoder"]["encoder_layers"][str(i)], x, self_mask,
            prior_states, None, n_heads=cfg.n_heads, dropout_rate=rate,
            rng=rng)
    return nn.layer_norm(params["decoder"]["layer_norm"], x)


def ssp_forward_loss(params, cfg: SSPConfig, verb, det_sr, gt_sr, rng=None,
                     row_weights=None, denom=None):
    """Teacher-forced label-smoothed loss (ref sort_model.py:80-103),
    divided by the count of scored positions.

    row_weights (B,): optional 0/1 row mask. Position 0 of every row is
    otherwise always scored (dec_mask starts with 1), so zero-padded rows
    would shift the loss; weighting them out keeps a padded batch's loss
    exactly the unpadded one. denom: the count of scored positions when
    these rows are a block of a larger batch (a 0-d tensor), else the
    rows' own."""
    gt_sr = gt_sr.to(torch.int32)
    b = gt_sr.shape[0]
    zeros = gt_sr.new_zeros((b, 1))
    dec_in = torch.cat([zeros, gt_sr], 1)                           # (B, L+1)
    dec_mask = torch.cat([torch.ones((b, 1), device=gt_sr.device),
                          (gt_sr != 0).float()], 1)
    if row_weights is not None:
        dec_mask = dec_mask * row_weights.float()[:, None]
    targets = torch.cat([gt_sr, zeros], 1)                          # (B, L+1)
    prior = ssp_encode(params, cfg, verb, det_sr, rng=rng)
    states = ssp_decode(params, cfg, dec_in, prior, rng=rng)
    logp = torch.log_softmax(nn.linear(params["expander_nn"], states), -1)
    return tfm.label_smoothing_kldiv(
        logp.reshape(-1, N_SR), targets.reshape(-1), dec_mask.reshape(-1),
        N_SR) / (dec_mask.sum() if denom is None else denom)


def _generate_loop(cfg: SSPConfig, det_sr, mode, logp_step, extra,
                   n_steps=None):
    """Shared greedy selection loop for ssp_generate / ssp_generate_fast.

    logp_step(extra, x_buf, t) -> (logp (B, 26), extra'): next-token
    log-probs at buffer position t; `extra` threads implementation state
    (the K/V caches).

    n_steps (constrained mode only): stop after this many steps. Each
    constrained step emits exactly one not-yet-used input slot, so once
    every row's slot multiset is exhausted the remaining steps write 0 and
    0.0, the buffers' initial values: n_steps >= the batch's largest slot
    count gives the same output as the full max_len loop.
    """
    b, l = det_sr.shape
    dev = det_sr.device
    t_max = cfg.max_len
    constrained = mode != "normal"
    if n_steps is None or not constrained:
        n_steps = t_max
    n_steps = min(int(n_steps), t_max)
    x_buf = torch.zeros((b, t_max + 1), dtype=torch.int32, device=dev)
    pred = torch.zeros((b, t_max), dtype=torch.int32, device=dev)
    lps = torch.zeros((b, t_max), device=dev)

    if constrained:
        remain = det_sr != 0
        rows = torch.arange(b, device=dev)
        for t in range(n_steps):
            active = remain.any(1)                                   # (B,)
            logp, extra = logp_step(extra, x_buf, t)
            slot_scores = torch.where(
                remain, torch.gather(logp, 1, det_sr.long()), -math.inf)
            score = slot_scores.amax(1)
            j = nn.first_argmax(slot_scores)                         # (B,)
            it = torch.where(active, det_sr[rows, j], 0)
            pred[:, t] = it
            lps[:, t] = torch.where(active, score, 0.0)
            remain[rows, j] &= ~active
            x_buf[:, t + 1] = it
        return pred, lps

    unfinished = torch.ones((b,), dtype=torch.bool, device=dev)
    alldone = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(t_max):
        execute = ~alldone
        logp, extra = logp_step(extra, x_buf, t)
        score = logp.amax(-1)
        it = nn.first_argmax(logp)
        it = it.to(torch.int32)
        unfinished = (it > 0) if t == 0 else unfinished & (it > 0)
        it_w = it * unfinished
        pred[:, t] = torch.where(execute, it_w, pred[:, t])
        lps[:, t] = torch.where(execute, score, lps[:, t])
        x_buf[:, t + 1] = torch.where(execute, it_w, 0)
        alldone = alldone | ~unfinished.any()
    return pred, lps


def _prepare(verb, det_sr, device):
    det_sr = torch.as_tensor(det_sr, device=device).to(torch.int32)
    return torch.as_tensor(verb, device=device), det_sr


@torch.no_grad()
def ssp_generate(params, cfg: SSPConfig, verb, det_sr, mode="normal",
                 n_steps=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive role-order generation (ref sort_model.py:105-183),
    re-running the full decoder over the token buffer at every step.

    mode='normal': unconstrained greedy with the reference's finished logic.
    Anything else (the eval scripts pass 'not-normal'): constrained — each
    step's argmax is restricted to the multiset of input SRs not yet emitted.
    n_steps: loop truncation, see _generate_loop (constrained only).

    Returns (pred (B, max_len) int32, logprobs (B, max_len) float32) on the
    parameters' device.
    """
    verb, det_sr = _prepare(verb, det_sr, params["expander_nn"]["weight"]
                            .device)
    prior = ssp_encode(params, cfg, verb, det_sr)

    def logp_step(extra, x_buf, t):
        states = ssp_decode(params, cfg, x_buf, prior)
        logits = nn.linear(params["expander_nn"], states[:, t])
        return torch.log_softmax(logits, -1), extra                  # (B, 26)

    return _generate_loop(cfg, det_sr, mode, logp_step, None, n_steps=n_steps)


@torch.no_grad()
def ssp_generate_fast(params, cfg: SSPConfig, verb, det_sr, mode="normal",
                      n_steps=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incremental (KV-cached) ssp_generate — same tokens, ~max_len× less
    decoder compute per step.

    Caching is exact because of three properties of the reference masking
    (token==0 keys masked with -1e3, which underflows to weight 0 in f32
    next to any live key; hence MASK_FILL stays -1e3, not -inf):

      1. a position's states are final once its token is written — later
         steps never change them (tokens are append-only and zero-terminal);
      2. token-0 positions (<bos>, pad, finished tails) are masked as KEYS
         everywhere, so their step-varying states never propagate;
      3. the only *read* of a degenerate all-keys-masked query is position t
         of a row whose buffer is entirely zeros (incl. every row at t=0),
         and with no positional encoding in the decoder embedding those
         outputs equal one position of an all-zeros-buffer pass, computed
         here once up front.

    Per step this computes only position t through the layers (fused QKV
    on one position, attention over the (max_len + 1)-slot cache,
    cross-attention over per-layer K/V of the encoder states, computed once
    from the SELF-attention projections as the reference layer does).
    """
    verb, det_sr = _prepare(verb, det_sr, params["expander_nn"]["weight"]
                            .device)
    b = det_sr.shape[0]
    s = cfg.max_len + 1
    n_heads = cfg.n_heads
    hd = cfg.hidden_size // n_heads
    prior = ssp_encode(params, cfg, verb, det_sr)
    layers = [params["decoder"]["encoder_layers"][str(i)]
              for i in range(cfg.decoder_layers)]

    # one single-position pass over an all-zeros buffer: the degenerate-
    # query outputs (property 3)
    zero_states = ssp_decode(
        params, cfg, torch.zeros((b, 1), dtype=torch.int32,
                                 device=det_sr.device), prior)
    zero_logp = torch.log_softmax(
        nn.linear(params["expander_nn"], zero_states[:, 0]), -1)    # (B, 26)

    def heads(x):
        return x.reshape(b, -1, n_heads, hd).transpose(1, 2)

    def unheads(x):
        return x.transpose(1, 2).reshape(b, -1, cfg.hidden_size)

    def attend(q, k, v, key_mask=None):
        # as tfm.mha_apply: product -> /sqrt(hd) -> -1e3 fill -> softmax
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if key_mask is not None:
            logits = torch.where(key_mask, logits, tfm.MASK_FILL)
        return unheads(torch.softmax(logits, -1) @ v)

    cross_kv = [(heads(nn.linear(lp["attention"]["linear_K"], prior)),
                 heads(nn.linear(lp["attention"]["linear_V"], prior)))
                for lp in layers]
    # fused per-layer QKV projection: one (H, 3H) product per step
    qkv_fused = [
        (torch.cat([lp["attention"][n]["weight"]
                    for n in ("linear_Q", "linear_K", "linear_V")], 0).T,
         torch.cat([lp["attention"][n]["bias"]
                    for n in ("linear_Q", "linear_K", "linear_V")], 0))
        for lp in layers]
    # caches live pre-headed as (B, nh, S, hd), written one position a step
    caches = [(prior.new_zeros((b, n_heads, s, hd)),
               prior.new_zeros((b, n_heads, s, hd))) for _ in layers]

    def logp_step(caches, x_buf, t):
        x = tfm.transformer_embed(params["sr_embed_layer"], x_buf[:, t:t + 1],
                                  cfg.embed_size)                   # (B, 1, H)
        # positions > t still hold token 0 in x_buf, so this single mask is
        # exactly the reference's causal+pad key mask for query position t
        key_mask = (x_buf != 0)[:, None, None, :]                   # (B,1,1,S)
        for lp, (ck, cv), (qkv_w, qkv_b), (k_cache, v_cache) in zip(
                layers, cross_kv, qkv_fused, caches):
            y1 = nn.layer_norm(lp["layer_norm1"], x)
            q_, k_, v_ = torch.chunk(y1 @ qkv_w + qkv_b, 3, dim=-1)
            k_cache[:, :, t:t + 1] = heads(k_)
            v_cache[:, :, t:t + 1] = heads(v_)
            h1 = nn.linear(lp["attention"]["linear_O"],
                           attend(heads(q_), k_cache, v_cache,
                                  key_mask)) + x
            y2 = nn.layer_norm(lp["layer_norm2"], h1)
            q2 = heads(nn.linear(lp["attention"]["linear_Q"], y2))
            h2 = nn.linear(lp["attention"]["linear_O"],
                           attend(q2, ck, cv)) + h1
            y3 = nn.layer_norm(lp["layer_norm3"], h2)
            x = tfm.ff_apply(lp["ff_layer"], y3) + h2
        states_t = nn.layer_norm(params["decoder"]["layer_norm"], x)[:, 0]
        logp = torch.log_softmax(nn.linear(params["expander_nn"], states_t),
                                 -1)                                # (B, 26)
        # degenerate rows (nothing emitted yet, which includes every row at
        # t=0) read the all-zeros-buffer pass instead
        deg = x_buf[:, 1] == 0
        return torch.where(deg[:, None], zero_logp, logp), caches

    return _generate_loop(cfg, det_sr, mode, logp_step, caches,
                          n_steps=n_steps)


@torch.no_grad()
def ssp_beam_search(params, cfg: SSPConfig, verb, det_sr, beam_size: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search over role sequences, re-running the full decoder
    over the token buffer at every step (JAX's functional replacement of
    the reference's dead `sample_beam`, sort_model.py:193). Token 0 is
    <eos>; at t = 0 only beam 0 is live; finished beams extend only with
    <eos> at zero cost. Candidates are ranked as `lax.top_k` ranks them
    (`core/nn.py::top_k`: the lowest flat index first among ties).

    Returns (sequences (B, beam, max_len) int32 by score descending,
    scores (B, beam)) on the parameters' device.
    """
    verb, det_sr = _prepare(verb, det_sr, params["expander_nn"]["weight"]
                            .device)
    dev = det_sr.device
    b, k, t_max = det_sr.shape[0], beam_size, cfg.max_len
    prior_k = torch.repeat_interleave(ssp_encode(params, cfg, verb, det_sr),
                                      k, 0)                         # (B*K,L,H)
    x_buf = torch.zeros((b * k, t_max + 1), dtype=torch.int32, device=dev)
    scores = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                         -math.inf).repeat(b, 1)                    # (B, K)
    alive = torch.ones((b, k), dtype=torch.bool, device=dev)
    seqs = torch.zeros((b, k, t_max), dtype=torch.int32, device=dev)
    eos_only = torch.where(torch.arange(N_SR, device=dev) == 0, 0.0,
                           -math.inf)
    row = (torch.arange(b * k, device=dev) // k) * k
    for t in range(t_max):
        states = ssp_decode(params, cfg, x_buf, prior_k)
        logp = torch.log_softmax(
            nn.linear(params["expander_nn"], states[:, t]), -1
        ).reshape(b, k, N_SR)
        logp = torch.where(alive[:, :, None], logp, eos_only)
        total = scores[:, :, None] + logp                          # (B,K,26)
        scores, idx = nn.top_k(total.reshape(b, k * N_SR), k)
        sel_beam = idx // N_SR
        tok = (idx - sel_beam * N_SR).to(torch.int32)
        seqs = torch.gather(seqs, 1, sel_beam[:, :, None].expand(-1, -1,
                                                                 t_max))
        seqs[:, :, t] = tok
        alive = torch.gather(alive, 1, sel_beam) & (tok != 0)
        x_buf = x_buf[row + sel_beam.reshape(-1)]
        x_buf[:, t + 1] = tok.reshape(-1)
    return seqs, scores
