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
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional

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


def derive_fused_step_weights(params, cfg: CaptionerConfig):
    """Concatenate the input_1-consuming projections (W1_is, W1_ig,
    lstm_cell_1 w_ih) into one product and the h1_prev-consuming ones
    (W1_hs, lstm w_hh) into another (W1_hg stays separate: the reference
    applies it to the post-update h1).

    x-side rows: [s-gate (R), g-gate-x (R), lstm ifgo (4R)];
    h-side rows: [s-gate (R), lstm ifgo (4R)].

    The x side is split into the image-descriptor columns (`wx_img`), whose
    projection is step-invariant and is hoisted to once per decode
    (Statics.img_y), and the remaining columns (`wx_nimg`).
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
    return {"bx": bx, "wh": wh, "bh": bh,
            "wx_img": wx[:, lo:lo + d].contiguous(),
            "wx_nimg": torch.cat([wx[:, :lo], wx[:, lo + d:]], 1)}


def _mm(x, w):
    """x (B, I) @ w (O, I)^T with x rounded to w's storage dtype and the
    product accumulated in f32 (the upcast operands are exact in f32)."""
    return x.to(w.dtype).float() @ w.float().T


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
    # fast routes: image_descriptor's input_1 projection + bias, hoisted
    # out of the decode loop (see derive_fused_step_weights)
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


class LinearProducts(NamedTuple):
    """The step's products one weight at a time (`nn.linear`,
    `nn.lstm_cell`), each where the strict step has always taken it (a
    backward's gradient sums keep their order). `fused`: the first products
    as derive_fused_step_weights' two, img_y (per row) hoisted."""
    fused: Optional[Dict[str, torch.Tensor]] = None

    def first(self, params, cfg, state, xt, image_descriptor, img_y, beam):
        """(s_gate, h1, c1, x): `gate` takes the g gate's x side from x."""
        if self.fused is None:
            if cfg.h2_first_lstm:
                in1 = torch.cat([state.h2, image_descriptor, xt], 1)
            else:
                in1 = torch.cat([image_descriptor, xt], 1)
            s_gate = torch.sigmoid(nn.linear(params["W1_is"], in1)
                                   + nn.linear(params["W1_hs"], state.h1))
            h1, c1 = nn.lstm_cell(params["lstm_cell_1"], in1,
                                  (state.h1, state.c1))
            return s_gate, h1, c1, in1
        fw, r = self.fused, cfg.rnn_size
        in1 = torch.cat([state.h2, xt], 1) if cfg.h2_first_lstm else xt
        if fw["wx_nimg"].dtype != in1.dtype:   # decode_dtype's bf16 weights
            y_x = _mm(in1, fw["wx_nimg"])
            y_h = _mm(state.h1, fw["wh"]) + fw["bh"]
        else:
            y_x = in1 @ fw["wx_nimg"].T                       # (B, 6R)
            y_h = state.h1 @ fw["wh"].T + fw["bh"]            # (B, 5R)
        y_x = y_x + img_y
        s_gate = torch.sigmoid(y_x[:, :r] + y_h[:, :r])
        g_x = y_x[:, r:2 * r]
        h1, c1 = nn.lstm_update(y_x[:, 2 * r:] + y_h[:, r:], state.c1)
        return s_gate, h1, c1, g_x

    def middle(self, params, cfg, s_t, h1):
        """(fc_sentinel, ha, sa, h): `gate` takes the h side from h."""
        fc_sentinel = nn.linear(params["s_fc"], s_t)
        ha = nn.linear(params["att_ha"], h1)
        return fc_sentinel, ha, nn.linear(params["att_sa"], s_t), h1

    def lstm2(self, params, cfg, x2, state):
        return nn.lstm_cell(params["lstm_cell_2"], torch.cat(x2, 1),
                            (state.h2, state.c2))

    def gate(self, params, cfg, x, h):
        g_x = x if self.fused is not None else nn.linear(params["W1_ig"], x)
        return g_x + nn.linear(params["W1_hg"], h)

    def g(self, params, cfg, g_t):
        return nn.linear(params["att_ga"], g_t)

    def head(self, params, cfg, h2):
        """The word logits, f32."""
        return nn.linear(params["out_fc"], h2).float()

    def regions(self, params, cfg, det_curr):
        """The group's attention projection att_va (B, M, A) (teacher
        forcing)."""
        return nn.linear(params["att_va"], det_curr)


class GroupedProducts(NamedTuple):
    """The step's products grouped by input (`derive_step_product_groups`),
    each group one call of `op` (`ops/step_planes.py::step_planes` or its
    plain version) on its `weights`: five calls a step; img_y (per item,
    `beam` rows an item) hoisted. The word head and the group's
    projection (`head`, `regions`) are calls of `op` on `weights`'
    "out_fc" and "att_va", which only XE training's route
    (`train/captioner.py::_xe_route`) builds and calls."""
    op: Callable
    weights: Dict[str, Any]

    def first(self, params, cfg, state, xt, image_descriptor, img_y, beam):
        r = cfg.rnn_size
        x = [state.h2, xt] if cfg.h2_first_lstm else [xt]
        y = self.op(x + [state.h1], self.weights["in1"], add=img_y,
                    add_div=beam)                              # (B, 6R)
        h1, c1 = nn.lstm_update(y[:, 2 * r:], state.c1)
        return torch.sigmoid(y[:, :r]), h1, c1, y[:, r:2 * r]

    def middle(self, params, cfg, s_t, h1):
        d, a = cfg.det_feat_size, cfg.att_size
        y_s = self.op([s_t], self.weights["s"])                # (B, D + A)
        y_h = self.op([h1], self.weights["h1"])                # (B, A + R)
        # fc_sentinel contiguous: the gathered attention concatenates it
        # with the (B, M, D) group, which a strided view sends down
        # torch.cat's slow path
        return y_s[:, :d].contiguous(), y_h[:, :a], y_s[:, d:], y_h[:, a:]

    def lstm2(self, params, cfg, x2, state):
        return nn.lstm_update(self.op(x2 + [state.h2], self.weights["lstm2"]),
                              state.c2)

    def gate(self, params, cfg, x, h):
        return x + h

    def g(self, params, cfg, g_t):
        return self.op([g_t], self.weights["g"])

    def head(self, params, cfg, h2):
        return self.op([h2], self.weights["out_fc"])

    def regions(self, params, cfg, det_curr):
        b, m, d = det_curr.shape
        return self.op([det_curr.reshape(b * m, d)],
                       self.weights["att_va"]).view(b, m, -1)


class StepRoute(NamedTuple):
    """A decode's products (`LinearProducts` or `GroupedProducts`) and
    attention (None: the group gathered, `_step_core`; else the fused op of
    `ops/fused_attention.py`, `_step_core_fused`): `api.step_route`."""
    products: Any = LinearProducts()
    attention: Optional[Callable] = None

    @property
    def kind(self):
        """What the steps run besides the route's tensors (a graph key)."""
        return (type(self.products), getattr(self.products, "op", None),
                self.attention)


STRICT = StepRoute()


def _step(params, cfg: CaptionerConfig, state: CaptionerState, it,
          image_descriptor, img_y, beam, products, attend, word_head):
    """The step's math, with two seams: `products` and `attend`
    ((ha, sa, fc_sentinel) -> (attended vector, gate evidence (B, 1))).
    Returns ((word_logp or None without word_head, gate_logp), (h1, c1, h2,
    c2))."""
    xt = nn.embedding(params["embed"], it)
    s_gate, h1, c1, gate_x = products.first(params, cfg, state, xt,
                                            image_descriptor, img_y, beam)
    s_t = s_gate * torch.tanh(c1)
    fc_sentinel, ha, sa, gate_h = products.middle(params, cfg, s_t, h1)
    att_detections, det_w_sum = attend(ha, sa, fc_sentinel)
    x2 = [h1, att_detections] + (
        [image_descriptor] if cfg.img_second_lstm else [])
    h2, c2 = products.lstm2(params, cfg, x2, state)
    word_logp = None
    if word_head:
        word_logp = torch.log_softmax(products.head(params, cfg, h2), dim=-1)

    # shift gate
    g_gate = torch.sigmoid(products.gate(params, cfg, gate_x, gate_h))
    g_t = g_gate * torch.tanh(c1)
    gate_w = nn.linear(params["att_g"],
                       torch.tanh(products.g(params, cfg, g_t) + ha))
    gate_logits = torch.cat([gate_w, det_w_sum], 1).float()
    return (word_logp, torch.log_softmax(gate_logits, dim=-1)), \
        (h1, c1, h2, c2)


def _step_core(params, cfg: CaptionerConfig, state: CaptionerState,
               it, det_curr, det_curr_proj, det_curr_mask, image_descriptor,
               word_head=True, products=LinearProducts(), img_y=None,
               beam=1):
    """The step on the already-gathered region group (teacher forcing,
    the strict and the grouped products' decodes).

    it: (B,) input word; det_curr: (B, M, D); det_curr_proj: (B, M, A);
    det_curr_mask: (B, M); image_descriptor: (B, D); img_y, beam: what the
    fast products read. Returns ((word_logp, gate_logp), (h1, c1, h2,
    c2)); `word_head=False` skips out_fc/log_softmax (word_logp is None).
    """
    return _step(params, cfg, state, it, image_descriptor, img_y, beam,
                 products, partial(_attend, params, det_curr, det_curr_proj,
                                   det_curr_mask), word_head)


def _attend(params, det_curr, det_curr_proj, det_curr_mask, ha, sa,
            fc_sentinel):
    """The additive attention over [sentinel ; regions], given ha =
    att_ha(h1) (B, A) and sa = att_sa(s_t) (B, A): returns (att_detections
    (B, D), the masked sum of the regions' weights (B, 1))."""
    det_w = torch.tanh(det_curr_proj + ha[:, None, :])     # (B, M, A)
    det_w = nn.linear(params["att_a"], det_w)              # (B, M, 1)
    sent_w = nn.linear(params["att_s"],
                       torch.tanh(sa + ha))[:, None, :]    # (B, 1, 1)

    att = torch.softmax(torch.cat([sent_w, det_w], 1), dim=1)  # (B, 1+M, 1)
    sent_mask = (fc_sentinel.sum(-1, keepdim=True) != 0).to(det_curr.dtype)
    regions_mask = torch.cat(
        [sent_mask[:, :, None], det_curr_mask[:, :, None]], 1)
    att = regions_mask * att
    att = att / att.sum(1, keepdim=True)
    regions = torch.cat([fc_sentinel[:, None, :], det_curr], 1)
    return (regions * att).sum(1), (det_curr_mask[:, :, None] * det_w).sum(1)


def derive_step_product_groups(params, cfg: CaptionerConfig, fw):
    """The candidate step's products grouped by their input, as
    `GroupedProducts` reads them: {name: (weight (N, K), bias (N,) or
    None)}, K the input's segments side by side.

      * "in1": [h2_prev, word embedding, h1_prev] ([embedding, h1_prev]
        without h2_first_lstm) -> [s-gate (R), g-gate x side (R), LSTM 1
        ifgo (4R)]: `fw`'s (derive_fused_step_weights, f32) x side
        without the image columns beside its h side, zeros where the g
        gate meets h1_prev (W1_hg reads the new h1, in "h1"); the image
        columns and bx come hoisted, per item (Statics.img_y);
      * "s": s_t -> [s_fc (D), att_sa (A)];
      * "h1": h1 -> [att_ha (A), W1_hg (R)];
      * "g": g_t -> att_ga (A);
      * "lstm2": [h1, att_detections, (image descriptor,) h2_prev] ->
        LSTM 2 ifgo (4R).
    The products with one output column (att_a, att_s, att_g) stay
    `nn.linear`."""
    r, a = cfg.rnn_size, cfg.att_size
    wh, bh = fw["wh"], fw["bh"]
    lstm2 = params["lstm_cell_2"]

    def weights(*names):
        return torch.cat([params[n]["weight"] for n in names], 0)

    return {
        "in1": (torch.cat([fw["wx_nimg"],
                           torch.cat([wh[:r], wh.new_zeros((r, r)), wh[r:]],
                                     0)], 1),
                torch.cat([bh[:r], bh.new_zeros((r,)), bh[r:]], 0)),
        "s": (weights("s_fc", "att_sa"),
              torch.cat([params["s_fc"]["bias"], bh.new_zeros((a,))], 0)),
        "h1": (weights("att_ha", "W1_hg"),
               torch.cat([bh.new_zeros((a,)), params["W1_hg"]["bias"]], 0)),
        "g": (params["att_ga"]["weight"], None),
        "lstm2": (torch.cat([lstm2["weight_ih"], lstm2["weight_hh"]], 1),
                  lstm2["bias_ih"] + lstm2["bias_hh"]),
    }


def _step_core_fused(params, cfg: CaptionerConfig, state: CaptionerState,
                     it, statics: Statics, ctrl, beam: int,
                     route: StepRoute, word_head=True):
    """The step through the fused group gather + attention op
    (`route.attention`): only the attended vector and gate evidence come
    back. img_y (per item) is expanded here to the beam rows."""
    rows = state.h1.shape[0]
    item = torch.arange(rows, device=state.h1.device) // beam
    img_y = statics.img_y
    if img_y.shape[0] != rows:
        img_y = img_y[item]
    image_descriptor = (statics.image_descriptor[item]
                        if cfg.img_second_lstm else None)
    return _step(params, cfg, state, it, image_descriptor, img_y, 1,
                 route.products,
                 partial(_attend_fused, route.attention, params, statics,
                         item, ctrl), word_head)


def _attend_fused(op, params, statics: Statics, item, ctrl, ha, sa,
                  fc_sentinel):
    """`_attend` by the fused op on the rows' items and ctrl pointers."""
    sent_w = nn.linear(params["att_s"], torch.tanh(sa + ha))
    sent_mask = (fc_sentinel.sum(-1, keepdim=True) != 0).to(
        fc_sentinel.dtype)
    return op(item.to(torch.int32), ctrl.to(torch.int32), ha.contiguous(),
              sent_w.contiguous(), sent_mask, fc_sentinel.contiguous(),
              params["att_a"]["weight"][0].float().contiguous(),
              statics.det_groups, statics.det_groups_proj)


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
        ctrl = state.ctrl_det_idx
        it = torch.full(ctrl.shape, cfg.bos_idx, dtype=torch.long,
                        device=ctrl.device)
        return it, ctrl
    ctrl = torch.clamp(state.ctrl_det_idx + prev_gate, 0,
                       statics.det_groups.shape[1] - 1)
    return prev_word, ctrl


def _feedback_step(params, cfg: CaptionerConfig, state: CaptionerState,
                   statics: Statics, prev_word, prev_gate, t0, beam: int,
                   route: StepRoute, word_head=True, verbs=False):
    """A feedback step through `route`: ((word_logp, gate_logp), new
    state, the rows' verbs (`_verb_curr`) or None without `verbs`)."""
    it, ctrl = _feedback_inputs(cfg, state, statics, prev_word, prev_gate, t0)
    gathered = route.attention is None
    image_descriptor, verb_list = (
        _per_row(statics, beam, state.h1.shape[0]) if verbs or gathered
        else (None, None))
    verb_curr = _verb_curr(verb_list, ctrl) if verbs else None
    if gathered:
        det_curr, det_proj, det_mask = _gather_group(statics, ctrl, beam)
        out, (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            image_descriptor, word_head=word_head, products=route.products,
            img_y=statics.img_y, beam=beam)
    else:
        out, (h1, c1, h2, c2) = _step_core_fused(
            params, cfg, state, it, statics, ctrl, beam, route,
            word_head=word_head)
    return out, CaptionerState(h1, c1, h2, c2, ctrl), verb_curr


def captioner_step(params, cfg: CaptionerConfig, state: CaptionerState,
                   statics: Statics, it=None, det_curr=None,
                   prev_word=None, prev_gate=None, t0=False, beam: int = 1,
                   route: StepRoute = STRICT):
    """One decode step.

    Teacher forcing: pass `it` (B,) and `det_curr` (B, M, D); the group's
    projection and mask are taken here, the pointer stays, and only
    statics.image_descriptor (and img_y, which XE's grouped route hoists)
    is read. Feedback (the step of `beam_search`, greedy and sampling): the
    ctrl pointer advances by prev_gate. Either runs through `route`'s
    products; feedback through its attention too."""
    if it is not None and det_curr is not None:
        products = route.products
        det_proj = products.regions(params, cfg, det_curr)
        det_mask = (det_curr.sum(-1) != 0).to(det_curr.dtype)
        (word_logp, gate_logp), (h1, c1, h2, c2) = _step_core(
            params, cfg, state, it, det_curr, det_proj, det_mask,
            statics.image_descriptor, products=products,
            img_y=statics.img_y)
        return ((word_logp, gate_logp),
                CaptionerState(h1, c1, h2, c2, state.ctrl_det_idx))
    out, state, _ = _feedback_step(params, cfg, state, statics, prev_word,
                                   prev_gate, t0, beam, route)
    return out, state


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
                     beam: int = 1, route: StepRoute = STRICT):
    """Feedback step with verb substitution (ref step_v :192-297).

    statics.verb_list (B, L) holds -1 for non-verb slots, else the verb id
    (verb vocab in pred mode / caption vocab in gt mode)."""
    (word_logp, gate_logp), state, verb_curr = _feedback_step(
        params, cfg, state, statics, prev_word, prev_gate, t0, beam, route,
        verbs=True)
    return substitute_verb(word_logp, gate_logp, verb_curr, tense_table,
                           gt), state


def _verb_target(out_fc, h2, verb_curr, tense_table: Optional[VerbTenseTable],
                 gt: bool, vocab_size: int):
    """Substitution target word per row without dense logits: only the
    tense-candidate rows of the head table `out_fc` ({"weight" (V, R),
    "bias" (V,)}) are scored (same argmax as substitute_verb: subtracting
    the row's lse does not change it)."""
    if gt:
        return torch.clamp(verb_curr, 0, vocab_size - 1)
    if tense_table is None:
        raise ValueError("_verb_target: pred mode needs a tense table")
    cand = _tense_candidates(tense_table, verb_curr)          # (B, Kt)
    safe = torch.clamp(cand, 0, vocab_size - 1)
    w_cols = out_fc["weight"][safe]                           # (B, Kt, R)
    dt = torch.promote_types(h2.dtype, w_cols.dtype)   # as jnp.einsum
    logits_cand = (torch.einsum("br,bkr->bk", h2.to(dt), w_cols.to(dt))
                   + out_fc["bias"][safe]).float()
    return _pick_tense(cand, logits_cand)


def captioner_step_v_topk(params, cfg: CaptionerConfig, state: CaptionerState,
                          statics: Statics,
                          tense_table: Optional[VerbTenseTable],
                          vocab_fn, out_fc_tables,
                          prev_word=None, prev_gate=None, t0=False, gt=False,
                          beam: int = 1, k: int = 5,
                          route: StepRoute = STRICT):
    """captioner_step_v emitting the compact candidate set consumed by
    decode.beam.beam_search_joint_candidates instead of dense word_logp.

    vocab_fn(h2, w_t, bias) -> (vals (B,k), ids (B,k), lse (B,1)): the
    wrapper or the plain version of `ops.vocab_topk`.
    out_fc_tables: (w_t (R, V), bias (V,)).
    Returns ((cand_ids (B, k+1), cand_wlp (B, k+1), gate_logp), state)."""
    (_, gate_logp), state, verb_curr = _feedback_step(
        params, cfg, state, statics, prev_word, prev_gate, t0, beam, route,
        word_head=False, verbs=True)
    w_t, bias = out_fc_tables
    vals, ids, lse = vocab_fn(state.h2.contiguous(), w_t, bias)
    tgt = _verb_target(params["out_fc"], state.h2, verb_curr, tense_table,
                       gt, cfg.vocab_size)
    return topk_candidates(vals, ids, lse, gate_logp, verb_curr, tgt, k), \
        state


def topk_candidates(vals, ids, lse, gate_logp, verb_curr, tgt, k: int):
    """A candidate step's (cand_ids (B, k+1), cand_wlp (B, k+1),
    gate_logp) for `beam_search_joint_candidates`, from the vocab op's
    top-k logits `vals`, their `ids` and the rows' `lse`, the rows' gate
    log-probs, their verb (`_verb_curr`, -1 off verb slots) and the verb
    rows' target words (`_verb_target`)."""
    b = vals.shape[0]
    dev = vals.device
    wlp_topk = vals - lse                                     # (B, k)

    # normal rows: top-k words + an inert slot (id 0, -inf)
    norm_ids = torch.cat([ids.long(), torch.zeros((b, 1), dtype=torch.long,
                                                  device=dev)], 1)
    norm_wlp = torch.cat([wlp_topk, torch.full((b, 1), -torch.inf,
                                               device=dev)], 1)

    # verb rows: forced tense word (logp 0) + the k lowest ids excluding
    # the target (logp -1e6): substitute_verb's sea in flat tie order
    sea_base = torch.arange(k, device=dev)[None, :]           # (1, k)
    sea_ids = sea_base + (tgt[:, None] <= sea_base).long()    # skip tgt
    verb_ids = torch.cat([tgt[:, None], sea_ids], 1)
    verb_wlp = torch.cat([torch.zeros((b, 1), device=dev),
                          torch.full((b, k), VERB_SEA, device=dev)], 1)

    is_verb = (verb_curr != -1)[:, None]
    cand_ids = torch.where(is_verb, verb_ids, norm_ids)
    cand_wlp = torch.where(is_verb, verb_wlp, norm_wlp)
    return cand_ids, cand_wlp, _gate_on_verbs(is_verb, gate_logp)
