"""Role-shift controllable captioning decoder: the per-step math.

Counterpart of `vsrcic_tpu/models/captioner.py`, with the same function
names and semantics (reference controllable_captioning.py:10-303):

  * image descriptor = masked mean of detections
  * LSTM1 input = [h2, image_descriptor, word_embed]
  * sentinel gate s_gate -> s_fc pseudo-region
  * additive attention over [sentinel ; current group]
  * LSTM2 -> word log-softmax
  * shift gate = log-softmax([g-attention, sum of masked det weights])
  * step_v verb substitution from a dense verb -> tense id table

Parameters are nested dicts of tensors in torch layout (`core/nn.py`). The
decode loops live in `vsrcic_tpu_torch.decode`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from vsrcic_tpu_torch.core import nn

# literal constants of the JAX step (captioner.py:524-526,650,656)
VERB_SEA = -1e6          # logprob of every non-target word on a verb row
GATE_CHANGE = -1e3       # gate logprob of "stay" on a verb row


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    seq_len: int = 20
    vocab_size: int = 10000
    bos_idx: int = 2
    det_feat_size: int = 2048
    input_encoding_size: int = 1000
    rnn_size: int = 1000
    att_size: int = 512
    h2_first_lstm: bool = True
    img_second_lstm: bool = False


def init_captioner_params(gen: torch.Generator, cfg: CaptionerConfig,
                          dtype=torch.float32) -> Dict[str, Any]:
    """Init matching reference controllable_captioning.py:72-107:
    xavier_normal weights and zero biases, orthogonal LSTM recurrent
    weights, zero LSTM biases. Tensors are made on the CPU."""
    d, e, r, a, v = (cfg.det_feat_size, cfg.input_encoding_size, cfg.rnn_size,
                     cfg.att_size, cfg.vocab_size)
    in1 = d + r + e if cfg.h2_first_lstm else d + e
    in2 = r + d + d if cfg.img_second_lstm else r + d

    def lin(i, o, bias=True):
        p = {"weight": nn.xavier_normal(gen, (o, i), dtype)}
        if bias:
            p["bias"] = torch.zeros((o,), dtype=dtype)
        return p

    def lstm(i, h):
        return {
            "weight_ih": nn.xavier_normal(gen, (4 * h, i), dtype),
            "weight_hh": torch.cat([nn.orthogonal(gen, (h, h), dtype)
                                    for _ in range(4)], 0),
            "bias_ih": torch.zeros((4 * h,), dtype=dtype),
            "bias_hh": torch.zeros((4 * h,), dtype=dtype),
        }

    return {
        "embed": {"weight": nn.xavier_normal(gen, (v, e), dtype)},
        "W1_is": lin(in1, r),
        "W1_hs": lin(r, r),
        "att_va": lin(d, a, bias=False),
        "att_ha": lin(r, a, bias=False),
        "att_a": lin(a, 1, bias=False),
        "att_sa": lin(r, a, bias=False),
        "att_s": lin(a, 1, bias=False),
        "lstm_cell_1": lstm(in1, r),
        "lstm_cell_2": lstm(in2, r),
        "out_fc": lin(r, v),
        "s_fc": lin(r, d),
        "W1_ig": lin(in1, r),
        "W1_hg": lin(r, r),
        "att_ga": lin(r, a, bias=False),
        "att_g": lin(a, 1, bias=False),
    }


def derive_fused_step_weights(params, cfg: CaptionerConfig, dtype=None):
    """Concatenate the input_1-consuming projections (W1_is, W1_ig,
    lstm_cell_1 w_ih) into one product and the h1_prev-consuming ones
    (W1_hs, lstm w_hh) into another (W1_hg stays separate: the reference
    applies it to the post-update h1).

    x-side rows: [s-gate (R), g-gate-x (R), lstm ifgo (4R)];
    h-side rows: [s-gate (R), lstm ifgo (4R)].

    The x side is split into the image-descriptor columns (`wx_img`), whose
    projection is step-invariant and is hoisted to once per decode
    (Statics.img_y), and the remaining columns (`wx_nimg`).
    dtype (e.g. bf16): store the big step weights (wx_nimg, wh,
    lstm_cell_2, s_fc) in that dtype; products accumulate in f32.
    """
    wx = torch.cat([params["W1_is"]["weight"], params["W1_ig"]["weight"],
                    params["lstm_cell_1"]["weight_ih"]], 0)
    bx = torch.cat([params["W1_is"]["bias"], params["W1_ig"]["bias"],
                    params["lstm_cell_1"]["bias_ih"]], 0)
    wh = torch.cat([params["W1_hs"]["weight"],
                    params["lstm_cell_1"]["weight_hh"]], 0)
    bh = torch.cat([params["W1_hs"]["bias"],
                    params["lstm_cell_1"]["bias_hh"]], 0)
    r, d = cfg.rnn_size, cfg.det_feat_size
    lo = r if cfg.h2_first_lstm else 0
    out = {"bx": bx, "wh": wh, "bh": bh,
           "wx_img": wx[:, lo:lo + d].contiguous(),
           "wx_nimg": torch.cat([wx[:, :lo], wx[:, lo + d:]], 1)}
    if dtype is not None:
        out["wh"] = wh.to(dtype)
        # wx_img stays f32: img_y is computed once per decode
        out["wx_nimg"] = out["wx_nimg"].to(dtype)
        out["w2_ih"] = params["lstm_cell_2"]["weight_ih"].to(dtype)
        out["w2_hh"] = params["lstm_cell_2"]["weight_hh"].to(dtype)
        out["b2"] = (params["lstm_cell_2"]["bias_ih"]
                     + params["lstm_cell_2"]["bias_hh"])
        out["sfc_w"] = params["s_fc"]["weight"].to(dtype)
    return out


def _mm(x, w):
    """x (B, I) @ w (O, I)^T with x rounded to w's storage dtype and the
    product accumulated in f32 (the upcast operands are exact in f32)."""
    return x.to(w.dtype).float() @ w.float().T


def _fused_input1_block(fused_w, input_1, h1_prev, c1_prev, rnn_size,
                        img_y):
    """Two fused products: returns (s_gate, g_pre_x, h1, c1); the caller
    finishes g_gate = sigmoid(g_pre_x + W1_hg(h1)).

    img_y: hoisted image-descriptor contribution (including bx), shape
    (rows, 6R); input_1 excludes the image slice."""
    r = rnn_size
    wx = fused_w["wx_nimg"]
    if wx.dtype != input_1.dtype:  # reduced-precision step weights
        y_x = _mm(input_1, wx)
        y_h = _mm(h1_prev, fused_w["wh"]) + fused_w["bh"]
    else:
        y_x = input_1 @ wx.T                              # (B, 6R)
        y_h = h1_prev @ fused_w["wh"].T + fused_w["bh"]   # (B, 5R)
    y_x = y_x + img_y
    s_gate = torch.sigmoid(y_x[:, :r] + y_h[:, :r])
    g_pre_x = y_x[:, r:2 * r]
    gates = y_x[:, 2 * r:] + y_h[:, r:]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c1 = torch.sigmoid(f) * c1_prev + torch.sigmoid(i) * torch.tanh(g)
    h1 = torch.sigmoid(o) * torch.tanh(c1)
    return s_gate, g_pre_x, h1, c1


class CaptionerState(NamedTuple):
    """Recurrent decode state. All fields have a leading batch dim."""
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    ctrl_det_idx: torch.Tensor  # (B,) int64: current region-group pointer


def init_state(cfg: CaptionerConfig, batch: int,
               device="cpu") -> CaptionerState:
    z = torch.zeros((batch, cfg.rnn_size), device=device)
    return CaptionerState(z, z, z, z,
                          torch.zeros((batch,), dtype=torch.long,
                                      device=device))


class Statics(NamedTuple):
    """Per-sequence inputs that are constant across decode steps."""
    image_descriptor: torch.Tensor      # (B, D)
    det_groups: torch.Tensor            # (B, L, M, D) region groups
    det_groups_proj: torch.Tensor       # (B, L, M, A) att_va(det_groups)
    det_groups_mask: torch.Tensor       # (B, L, M) 1.0 where region non-zero
    verb_list: Optional[torch.Tensor]   # (B, L) verb ids or -1 (step_v only)
    # fast path: image_descriptor's input_1 projection + bias, hoisted out
    # of the decode loop (see derive_fused_step_weights)
    img_y: Optional[torch.Tensor] = None   # (B, 6R)


def image_descriptor_f32(detections):
    """Masked mean of the detections (B, N, D) as an f32 quotient of sums
    taken in the detections' dtype. The JAX program rounds the bf16 sums
    but, compiled, hands the quotient to the f32 image projection without
    rounding it to bf16 (XLA removes the bf16 round trip); the hoisted
    `img_y` is computed from this value to match it."""
    det_mask = (detections.sum(-1, keepdim=True) != 0).to(detections.dtype)
    return detections.sum(1).float() / det_mask.sum(1).float()


def precompute_statics(params, cfg: CaptionerConfig, detections, det_groups,
                       verb_list=None) -> Statics:
    """detections: (B, N, D) raw detections; det_groups: (B, L, M, D).
    Computed in the inputs' dtype, as the JAX step does (the projection of
    bf16 groups by f32 weights is an f32 product of their upcast; by bf16
    weights a bf16 product)."""
    image_descriptor = image_descriptor_f32(detections).to(detections.dtype)
    groups_proj = nn.linear(params["att_va"], det_groups)
    groups_mask = (det_groups.sum(-1) != 0).to(det_groups.dtype)
    return Statics(image_descriptor, det_groups, groups_proj, groups_mask,
                   verb_list)


def _step_core(params, cfg: CaptionerConfig, state: CaptionerState,
               it, det_curr, det_curr_proj, det_curr_mask, image_descriptor,
               word_head=True):
    """Shared math of step/step_v given the already-gathered region group.

    it: (B,) input word; det_curr: (B, M, D); det_curr_proj: (B, M, A);
    det_curr_mask: (B, M). Returns ((word_logp, gate_logp), (h1, c1, h2,
    c2)); `word_head=False` skips out_fc/log_softmax (word_logp is None).
    """
    xt = nn.embedding(params["embed"], it)
    if cfg.h2_first_lstm:
        input_1 = torch.cat([state.h2, image_descriptor, xt], 1)
    else:
        input_1 = torch.cat([image_descriptor, xt], 1)

    s_gate = torch.sigmoid(nn.linear(params["W1_is"], input_1)
                           + nn.linear(params["W1_hs"], state.h1))
    h1, c1 = nn.lstm_cell(params["lstm_cell_1"], input_1, (state.h1, state.c1))

    s_t = s_gate * torch.tanh(c1)
    fc_sentinel = nn.linear(params["s_fc"], s_t)          # (B, D)

    # additive attention over [sentinel ; regions]
    ha = nn.linear(params["att_ha"], h1)                   # (B, A)
    det_w = torch.tanh(det_curr_proj + ha[:, None, :])     # (B, M, A)
    det_w = nn.linear(params["att_a"], det_w)              # (B, M, 1)
    sent_w = torch.tanh(nn.linear(params["att_sa"], s_t) + ha)
    sent_w = nn.linear(params["att_s"], sent_w)[:, None, :]  # (B, 1, 1)

    att = torch.softmax(torch.cat([sent_w, det_w], 1), dim=1)  # (B, 1+M, 1)
    sent_mask = (fc_sentinel.sum(-1, keepdim=True) != 0).to(det_curr.dtype)
    regions_mask = torch.cat(
        [sent_mask[:, :, None], det_curr_mask[:, :, None]], 1)
    att = regions_mask * att
    att = att / att.sum(1, keepdim=True)
    regions = torch.cat([fc_sentinel[:, None, :], det_curr], 1)
    att_detections = (regions * att).sum(1)                # (B, D)

    if cfg.img_second_lstm:
        input_2 = torch.cat([h1, att_detections, image_descriptor], 1)
    else:
        input_2 = torch.cat([h1, att_detections], 1)
    h2, c2 = nn.lstm_cell(params["lstm_cell_2"], input_2, (state.h2, state.c2))
    word_logp = None
    if word_head:
        word_logits = nn.linear(params["out_fc"], h2).float()
        word_logp = torch.log_softmax(word_logits, dim=-1)

    # shift gate
    g_gate = torch.sigmoid(nn.linear(params["W1_ig"], input_1)
                           + nn.linear(params["W1_hg"], h1))
    g_t = g_gate * torch.tanh(c1)
    gate_w = torch.tanh(nn.linear(params["att_ga"], g_t) + ha)
    gate_w = nn.linear(params["att_g"], gate_w)            # (B, 1)
    det_w_sum = (det_curr_mask[:, :, None] * det_w).sum(1)  # (B, 1)
    gate_logits = torch.cat([gate_w, det_w_sum], 1).float()
    gate_logp = torch.log_softmax(gate_logits, dim=-1)
    return (word_logp, gate_logp), (h1, c1, h2, c2)


def _step_core_fused(params, cfg: CaptionerConfig, state: CaptionerState,
                     it, statics: Statics, ctrl, beam: int, fused_fn,
                     fused_w, word_head=True):
    """_step_core through the fused group gather + attention op
    (`ops/fused_attention.py`): the region group is read and attended in
    the kernel and only the attended vector and gate evidence come back.
    Uses the fused step weights with the hoisted image projection
    (`statics.img_y`, per item; expanded here to the beam rows)."""
    rows = state.h1.shape[0]
    item = torch.arange(rows, device=state.h1.device) // beam
    xt = nn.embedding(params["embed"], it)
    img_y = statics.img_y
    if img_y.shape[0] != rows:
        img_y = img_y[item]
    input_1p = torch.cat([state.h2, xt], 1) if cfg.h2_first_lstm else xt
    s_gate, g_pre_x, h1, c1 = _fused_input1_block(
        fused_w, input_1p, state.h1, state.c1, cfg.rnn_size, img_y=img_y)
    s_t = s_gate * torch.tanh(c1)
    if "sfc_w" in fused_w:
        fc_sentinel = _mm(s_t, fused_w["sfc_w"]) + params["s_fc"]["bias"]
    else:
        fc_sentinel = nn.linear(params["s_fc"], s_t)          # (B, D)

    ha = nn.linear(params["att_ha"], h1)                      # (B, A)
    sent_w = nn.linear(params["att_s"],
                       torch.tanh(nn.linear(params["att_sa"], s_t) + ha))
    sent_mask = (fc_sentinel.sum(-1, keepdim=True) != 0).to(
        fc_sentinel.dtype)
    att_detections, det_w_sum = fused_fn(
        item.to(torch.int32), ctrl.to(torch.int32), ha.contiguous(),
        sent_w.contiguous(), sent_mask, fc_sentinel.contiguous(),
        params["att_a"]["weight"][0].float().contiguous(),
        statics.det_groups, statics.det_groups_proj)

    if cfg.img_second_lstm:
        image_descriptor = statics.image_descriptor[item]
        input_2 = torch.cat([h1, att_detections, image_descriptor], 1)
    else:
        input_2 = torch.cat([h1, att_detections], 1)
    if "w2_ih" in fused_w:
        gates2 = (_mm(input_2, fused_w["w2_ih"])
                  + _mm(state.h2, fused_w["w2_hh"]) + fused_w["b2"])
        i2, f2, g2, o2 = torch.chunk(gates2, 4, dim=-1)
        c2 = (torch.sigmoid(f2) * state.c2
              + torch.sigmoid(i2) * torch.tanh(g2))
        h2 = torch.sigmoid(o2) * torch.tanh(c2)
    else:
        h2, c2 = nn.lstm_cell(params["lstm_cell_2"], input_2,
                              (state.h2, state.c2))
    word_logp = None
    if word_head:
        word_logits = nn.linear(params["out_fc"], h2).float()
        word_logp = torch.log_softmax(word_logits, dim=-1)

    g_gate = torch.sigmoid(g_pre_x + nn.linear(params["W1_hg"], h1))
    g_t = g_gate * torch.tanh(c1)
    gate_w = nn.linear(params["att_g"],
                       torch.tanh(nn.linear(params["att_ga"], g_t) + ha))
    gate_logits = torch.cat([gate_w, det_w_sum], 1).float()
    gate_logp = torch.log_softmax(gate_logits, dim=-1)
    return (word_logp, gate_logp), (h1, c1, h2, c2)


def _gather_group(statics: Statics, idx, beam: int = 1):
    """The current region group (+ proj/mask) at ctrl pointer idx.

    `beam` > 1: the decode rows are item-major beam-expanded while the
    statics tables stay per item; all beams of an item share its groups.
    idx: (B_items * beam,)."""
    item = torch.arange(idx.shape[0], device=idx.device) // beam
    take = lambda a: a[item, idx]
    return take(statics.det_groups), take(statics.det_groups_proj), \
        take(statics.det_groups_mask)


def _per_row(statics: Statics, beam: int, rows: int):
    """image_descriptor (and verb_list) per decode row for beam-expanded
    decodes over per-item statics."""
    if beam == 1:
        return statics.image_descriptor, statics.verb_list
    item = torch.arange(rows, device=statics.image_descriptor.device) // beam
    vl = statics.verb_list[item] if statics.verb_list is not None else None
    return statics.image_descriptor[item], vl


def _feedback_inputs(cfg, state, statics, prev_word, prev_gate, t0):
    """(input word, ctrl pointer) of a feedback step: BOS and the initial
    pointer at t0, else the previous word and the pointer advanced by the
    previous gate, clipped to the last group."""
    if t0:
        b = state.h1.shape[0]
        it = torch.full((b,), cfg.bos_idx, dtype=torch.long,
                        device=state.h1.device)
        return it, state.ctrl_det_idx
    ctrl = torch.clamp(state.ctrl_det_idx + prev_gate, 0,
                       statics.det_groups.shape[1] - 1)
    return prev_word, ctrl


def captioner_step(params, cfg: CaptionerConfig, state: CaptionerState,
                   statics: Statics, it=None, det_curr=None,
                   prev_word=None, prev_gate=None, t0=False, beam: int = 1,
                   fused_fn=None, fused_w=None):
    """One decode step.

    Teacher forcing: pass `it` (B,) and `det_curr` (B, M, D); the group's
    projection and mask are taken here, the pointer stays, and only
    statics.image_descriptor is read. Feedback (the step of `beam_search`,
    greedy and sampling): the ctrl pointer advances by prev_gate and the
    group is gathered from statics, or attended in the fused op when
    fused_fn is given."""
    b = state.h1.shape[0]
    if it is not None and det_curr is not None:
        det_proj = nn.linear(params["att_va"], det_curr)
        det_mask = (det_curr.sum(-1) != 0).to(det_curr.dtype)
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            statics.image_descriptor)
        return ((word_logp, gate_logp),
                CaptionerState(h1, c1, h2, c2, state.ctrl_det_idx))
    it, ctrl = _feedback_inputs(cfg, state, statics, prev_word, prev_gate, t0)
    if fused_fn is not None:
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core_fused(
            params, cfg, state, it, statics, ctrl, beam, fused_fn, fused_w)
    else:
        det_curr, det_proj, det_mask = _gather_group(statics, ctrl, beam)
        image_descriptor, _ = _per_row(statics, beam, b)
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            image_descriptor)
    return (word_logp, gate_logp), CaptionerState(h1, c1, h2, c2, ctrl)


class VerbTenseTable(NamedTuple):
    """Dense verb -> candidate word-vocab ids.

    ids: (n_verbs+1, max_tenses) int64, -1 padded. Row v lists, in JSON
    list order, the caption-vocab ids of all tenses of verb v."""
    ids: torch.Tensor

    @property
    def max_tenses(self):
        return self.ids.shape[1]


def _pick_tense(cand, scores):
    """Target word of each verb row: the best-scoring valid tense candidate
    (first maximum wins), or word 0 where the verb has no tenses."""
    cand_valid = cand >= 0
    scores = torch.where(cand_valid, scores, -torch.inf)
    best_k = nn.first_argmax(scores)
    tgt = torch.gather(cand, 1, best_k[:, None])[:, 0]
    return torch.where(cand_valid.any(1), tgt, torch.zeros_like(tgt))


def _tense_candidates(tense_table: VerbTenseTable, verb_curr):
    return tense_table.ids[torch.clamp(verb_curr, 0,
                                       tense_table.ids.shape[0] - 1)]


def _gate_on_verbs(is_verb, gate_logp):
    """gate_logp with the rows where is_verb (B, 1) holds set to
    (GATE_CHANGE, 0.0). The constants go in as scalars: a tensor made from
    host values is copied to the card, and that copy waits for the stream."""
    stay = torch.arange(2, device=gate_logp.device) == 0
    return torch.where(is_verb & stay, GATE_CHANGE,
                       torch.where(is_verb, 0.0, gate_logp))


def substitute_verb(word_logp, gate_logp, verb_curr,
                    tense_table: Optional[VerbTenseTable], gt: bool):
    """Vectorized verb substitution (ref controllable_captioning.py:271-295).

    verb_curr: (B,) -1 where no substitution; verb-vocab id (pred mode) or
    caption-vocab id (gt mode) at verb slots."""
    b, v = word_logp.shape
    mask = verb_curr != -1
    if gt:
        tgt = torch.clamp(verb_curr, 0, v - 1)
    else:
        if tense_table is None:
            raise ValueError("substitute_verb: pred mode needs a tense table")
        cand = _tense_candidates(tense_table, verb_curr)
        tgt = _pick_tense(cand, torch.gather(
            word_logp, 1, torch.clamp(cand, 0, v - 1)))
    verb_out = torch.full((b, v), VERB_SEA, dtype=word_logp.dtype,
                          device=word_logp.device)
    verb_out[torch.arange(b, device=word_logp.device), tgt] = 0.0
    word_out = torch.where(mask[:, None], verb_out, word_logp)
    return word_out, _gate_on_verbs(mask[:, None], gate_logp)


def _verb_curr(verb_list, ctrl):
    # NB: the reference gathers verb_curr at t=0 too (ref :219-223): a verb
    # in the first group substitutes already at the first step
    return torch.gather(verb_list, 1, ctrl[:, None])[:, 0].long()


def captioner_step_v(params, cfg: CaptionerConfig, state: CaptionerState,
                     statics: Statics, tense_table: Optional[VerbTenseTable],
                     prev_word=None, prev_gate=None, t0=False, gt=False,
                     beam: int = 1, fused_fn=None, fused_w=None):
    """Feedback step with verb substitution (ref step_v :192-297).

    statics.verb_list (B, L) holds -1 for non-verb slots, else the verb id
    (verb vocab in pred mode / caption vocab in gt mode)."""
    b = state.h1.shape[0]
    it, ctrl = _feedback_inputs(cfg, state, statics, prev_word, prev_gate, t0)
    image_descriptor, verb_list = _per_row(statics, beam, b)
    verb_curr = _verb_curr(verb_list, ctrl)
    if fused_fn is not None:
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core_fused(
            params, cfg, state, it, statics, ctrl, beam, fused_fn, fused_w)
    else:
        det_curr, det_proj, det_mask = _gather_group(statics, ctrl, beam)
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            image_descriptor)
    word_logp, gate_logp = substitute_verb(word_logp, gate_logp, verb_curr,
                                           tense_table, gt)
    return (word_logp, gate_logp), CaptionerState(h1, c1, h2, c2, ctrl)


def _verb_target(params, h2, verb_curr, tense_table: Optional[VerbTenseTable],
                 gt: bool, vocab_size: int):
    """Substitution target word per row without dense logits: only the
    tense-candidate columns of out_fc are scored (same argmax as
    substitute_verb: subtracting the row's lse does not change it)."""
    if gt:
        return torch.clamp(verb_curr, 0, vocab_size - 1)
    if tense_table is None:
        raise ValueError("_verb_target: pred mode needs a tense table")
    cand = _tense_candidates(tense_table, verb_curr)          # (B, Kt)
    safe = torch.clamp(cand, 0, vocab_size - 1)
    w_cols = params["out_fc"]["weight"][safe]                 # (B, Kt, R)
    dt = torch.promote_types(h2.dtype, w_cols.dtype)   # as jnp.einsum
    logits_cand = (torch.einsum("br,bkr->bk", h2.to(dt), w_cols.to(dt))
                   + params["out_fc"]["bias"][safe]).float()
    return _pick_tense(cand, logits_cand)


def captioner_step_v_topk(params, cfg: CaptionerConfig, state: CaptionerState,
                          statics: Statics,
                          tense_table: Optional[VerbTenseTable],
                          vocab_fn, out_fc_tables,
                          prev_word=None, prev_gate=None, t0=False, gt=False,
                          beam: int = 1, k: int = 5, fused_fn=None,
                          fused_w=None):
    """captioner_step_v emitting the compact candidate set consumed by
    decode.beam.beam_search_joint_candidates instead of dense word_logp.

    vocab_fn(h2, w_t, bias) -> (vals (B,k), ids (B,k), lse (B,1)): the
    wrapper or the plain version of `ops.vocab_topk`.
    out_fc_tables: (w_t (R, V), bias (V,)).
    Returns ((cand_ids (B, k+1), cand_wlp (B, k+1), gate_logp), state)."""
    b = state.h1.shape[0]
    v = cfg.vocab_size
    dev = state.h1.device
    it, ctrl = _feedback_inputs(cfg, state, statics, prev_word, prev_gate, t0)
    image_descriptor, verb_list = _per_row(statics, beam, b)
    verb_curr = _verb_curr(verb_list, ctrl)
    if fused_fn is not None:
        (_, gate_logp), (h1, c1, h2, c2) = _step_core_fused(
            params, cfg, state, it, statics, ctrl, beam, fused_fn, fused_w,
            word_head=False)
    else:
        det_curr, det_proj, det_mask = _gather_group(statics, ctrl, beam)
        (_, gate_logp), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            image_descriptor, word_head=False)

    w_t, bias = out_fc_tables
    vals, ids, lse = vocab_fn(h2.contiguous(), w_t, bias)
    wlp_topk = vals - lse                                     # (B, k)

    # normal rows: top-k words + an inert slot (id 0, -inf)
    norm_ids = torch.cat([ids.long(), torch.zeros((b, 1), dtype=torch.long,
                                                  device=dev)], 1)
    norm_wlp = torch.cat([wlp_topk, torch.full((b, 1), -torch.inf,
                                               device=dev)], 1)

    # verb rows: forced tense word (logp 0) + the k lowest ids excluding
    # the target (logp -1e6): substitute_verb's sea in flat tie order
    tgt = _verb_target(params, h2, verb_curr, tense_table, gt, v)
    sea_base = torch.arange(k, device=dev)[None, :]           # (1, k)
    sea_ids = sea_base + (tgt[:, None] <= sea_base).long()    # skip tgt
    verb_ids = torch.cat([tgt[:, None], sea_ids], 1)
    verb_wlp = torch.cat([torch.zeros((b, 1), device=dev),
                          torch.full((b, k), VERB_SEA, device=dev)], 1)

    is_verb = (verb_curr != -1)[:, None]
    cand_ids = torch.where(is_verb, verb_ids, norm_ids)
    cand_wlp = torch.where(is_verb, verb_wlp, norm_wlp)
    gate_out = _gate_on_verbs(is_verb, gate_logp)
    return ((cand_ids, cand_wlp, gate_out),
            CaptionerState(h1, c1, h2, c2, ctrl))
