"""Greedy, sampled, forced and teacher-forced decode loops.

Counterpart of `vsrcic_tpu/decode/loops.py`, with the same function names
and semantics. JAX's `lax.scan` is a Python loop over the steps and its
`lax.cond(t == 0, ...)` a Python branch on the step index; `jax.checkpoint`
around a step is `torch.utils.checkpoint.checkpoint` (non-reentrant).
Random draws come from a caller-owned `torch.Generator` on the decode's
device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from vsrcic_tpu_torch.core import nn
from vsrcic_tpu_torch.models.captioner import (
    STRICT, CaptionerConfig, CaptionerState, Statics, StepRoute, _step_core,
    captioner_step, init_state, precompute_statics)


def expand_compact_groups(detections, det_ids):
    """Region groups from compact indices.

    detections: (B, N, D); det_ids: (B, ..., M) int with -1 padding ->
    (B, ..., M, D) feature groups, padding rows zero."""
    b, n, d = detections.shape
    safe = det_ids.long().clamp(0, n - 1).reshape(b, -1)        # (B, K)
    feats = detections[torch.arange(b, device=detections.device)[:, None],
                       safe]
    feats = feats.reshape(tuple(det_ids.shape) + (d,))
    return torch.where((det_ids >= 0)[..., None], feats, 0.0)


def forward_teacher_forcing_compact(params, cfg: CaptionerConfig, detections,
                                    captions, det_ids):
    """Teacher forcing on groups expanded from compact ids."""
    return forward_teacher_forcing(params, cfg, detections, captions,
                                   expand_compact_groups(detections, det_ids))


def forward_teacher_forcing(params, cfg: CaptionerConfig, detections,
                            captions, ctrl_det_seqs):
    """Teacher-forced forward.

    detections: (B, N, D); captions: (B, T) int; ctrl_det_seqs: (B, T, M, D).
    Returns (word_logp (B, T, V), gate_logp (B, T, 2)). The groups'
    projections for all T steps are one product, taken before the loop."""
    b, t_len = captions.shape
    captions = captions.long()
    statics = precompute_statics(params, cfg, detections, ctrl_det_seqs)
    state = init_state(cfg, b, device=detections.device)
    word_logp, gate_logp = [], []
    for t in range(t_len):
        (w, g), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, captions[:, t], ctrl_det_seqs[:, t],
            statics.det_groups_proj[:, t], statics.det_groups_mask[:, t],
            statics.image_descriptor)
        state = CaptionerState(h1, c1, h2, c2, state.ctrl_det_idx)
        word_logp.append(w)
        gate_logp.append(g)
    return torch.stack(word_logp, 1), torch.stack(gate_logp, 1)


def _feedback_start(cfg: CaptionerConfig, statics: Statics):
    """(state, previous word, previous gate) before a feedback decode."""
    b = statics.image_descriptor.shape[0]
    dev = statics.image_descriptor.device
    zero = torch.zeros((b,), dtype=torch.long, device=dev)
    return init_state(cfg, b, device=dev), zero, zero


def greedy_decode(params, cfg: CaptionerConfig, statics: Statics,
                  seq_len: Optional[int] = None, route: StepRoute = STRICT):
    """Greedy feedback decode: words and gates by their first maximum (as
    `jnp.argmax`). Returns (words (B, T), gates (B, T)) int64."""
    state, word, gate = _feedback_start(cfg, statics)
    words, gates = [], []
    for t in range(seq_len or cfg.seq_len):
        (w_logp, g_logp), state = captioner_step(
            params, cfg, state, statics, prev_word=word, prev_gate=gate,
            t0=t == 0, route=route)
        word = nn.first_argmax(w_logp)
        gate = nn.first_argmax(g_logp)
        words.append(word)
        gates.append(gate)
    return torch.stack(words, 1), torch.stack(gates, 1)


def _take(logp, idx):
    return torch.gather(logp, 1, idx[:, None])[:, 0]


def forced_feedback_logprobs(params, cfg: CaptionerConfig, statics: Statics,
                             words, gates, remat: bool = False):
    """Differentiable logprobs of a given (word, gate) trajectory.

    Re-runs the feedback decode feeding the given outputs back (the region
    pointer advances by the given gates) and returns each step's logprobs
    of those outputs, (B, T) each: SCST's gradient pass. remat=True
    checkpoints each step, so that the backward recomputes the step's
    gathered group and attention instead of storing them."""
    words = words.long()
    gates = gates.long()
    state, prev_word, prev_gate = _feedback_start(cfg, statics)

    def body(state, prev_word, prev_gate, word_t, gate_t, t0):
        (w_logp, g_logp), state = captioner_step(
            params, cfg, state, statics, prev_word=prev_word,
            prev_gate=prev_gate, t0=t0)
        return state, _take(w_logp, word_t), _take(g_logp, gate_t)

    w_lps, g_lps = [], []
    for t in range(words.shape[1]):
        args = (state, prev_word, prev_gate, words[:, t], gates[:, t], t == 0)
        if remat:  # the step draws no random numbers: no RNG state to keep
            state, w_lp, g_lp = checkpoint(body, *args, use_reentrant=False,
                                           preserve_rng_state=False)
        else:
            state, w_lp, g_lp = body(*args)
        prev_word, prev_gate = words[:, t], gates[:, t]
        w_lps.append(w_lp)
        g_lps.append(g_lp)
    return torch.stack(w_lps, 1), torch.stack(g_lps, 1)


def categorical(gen, logits):
    """One draw per row from softmax(logits), as `jax.random.categorical`
    draws it: the first maximum of logits + Gumbel noise. gen: a
    torch.Generator or a `core.nn.BlockRNG`."""
    u = nn.rand(gen, logits.shape, logits.device)
    return nn.first_argmax(logits - torch.log(-torch.log(u)))


def sample_decode(params, cfg: CaptionerConfig, statics: Statics,
                  gen: torch.Generator, seq_len: Optional[int] = None,
                  route: StepRoute = STRICT):
    """Ancestral sampling with per-step logprobs.

    gen: a generator on the statics' device (or a `core.nn.BlockRNG` over
    one). Returns ((words, gates), (word_logps, gate_logps)), each
    (B, T)."""
    state, word, gate = _feedback_start(cfg, statics)
    out = [], [], [], []
    for t in range(seq_len or cfg.seq_len):
        (w_logp, g_logp), state = captioner_step(
            params, cfg, state, statics, prev_word=word, prev_gate=gate,
            t0=t == 0, route=route)
        word = categorical(gen, w_logp)
        gate = categorical(gen, g_logp)
        for acc, x in zip(out, (
                word, gate, _take(torch.log_softmax(w_logp, -1), word),
                _take(torch.log_softmax(g_logp, -1), gate))):
            acc.append(x)
    words, gates, w_lps, g_lps = (torch.stack(a, 1) for a in out)
    return (words, gates), (w_lps, g_lps)
