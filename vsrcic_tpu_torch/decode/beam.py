"""Joint (word x shift-gate) beam search.

Counterpart of `vsrcic_tpu/decode/beam.py` (reference
models/CaptioningModel.py:116-294). The beam state -- recurrent state,
running scores, EOS masks, emitted tokens and per-step logprobs -- is a set
of fixed-shape tensors advanced by a Python loop over steps (JAX's
`lax.scan`), with beam reindexing as flat row gathers. Semantics kept from
the JAX engine:

  * the joint top-k over the flattened (beam x vocab x gate) scores, with
    `lax.top_k`'s tie order (lowest flat index first among equal scores);
  * EOS masking of the recorded per-step logprobs;
  * the finished-beam freeze that pins a beam's score to word 0 and puts a
    -999 sea on every other word, active only when all outputs hit EOS;
  * records that track beam slots, not ancestries (ref :273).

`step_fn(state, prev_word, prev_gate, t0) -> ((word_logp, gate_logp), state)`
runs over the flattened (batch*beam) leading dim. Each step, t = 0 too,
runs inside a span `beam.step` of the recorder (`utils/observability.py`)
with the count `t`.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from vsrcic_tpu_torch.core.nn import top_k, total_order_key
from vsrcic_tpu_torch.utils import observability as obs

FROZEN_SEA = -999.0   # ref CaptioningModel.py:231-235


class BeamResult(NamedTuple):
    words: torch.Tensor        # (B, K, T) int64, beams sorted by score desc
    gates: torch.Tensor        # (B, K, T) int64
    word_logps: torch.Tensor   # (B, K, T)
    gate_logps: torch.Tensor   # (B, K, T)
    scores: torch.Tensor       # (B, K)


def _gather_beam(state, sel, batch, beam):
    """Reindex every (batch*beam, ...) field by per-item beam selection
    sel (B, K): one flat row gather per field."""
    rows = (torch.arange(batch, device=sel.device)[:, None] * beam
            + sel).reshape(-1)
    return type(state)(*(x[rows] for x in state))


def _record(o, sel_beam, idx):
    """o (B, K, V) at flat (beam, idx) positions -> (B, K)."""
    return torch.gather(o.reshape(o.shape[0], -1), 1,
                        sel_beam * o.shape[-1] + idx)


def _split_flat(idx, v2):
    sel_beam = idx // v2
    rem = idx - sel_beam * v2
    word = rem // 2
    return sel_beam, word, rem - word * 2


def _history(seq_len, batch, k, device, first, dtype):
    out = torch.zeros((batch, k, seq_len), dtype=dtype, device=device)
    out[:, :, 0] = first
    return out


def beam_search_joint(step_fn: Callable, state, batch: int, beam_size: int,
                      seq_len: int, eos_word: int,
                      eos_gate: int = -1) -> BeamResult:
    """Run the dense joint beam search.

    `state` must already be expanded to leading dim batch*beam_size with all
    beams of an item identical (beam 0 is the live one at t=0)."""
    k = beam_size
    dev = state[0].device

    def joint_topk(seq_logprob, w, g, frozen=None, beam0_only=False):
        total = (seq_logprob[:, :, None, None] + w[:, :, :, None]
                 + g[:, :, None, :])
        if frozen is not None:
            word_is0 = (torch.arange(w.shape[-1], device=dev) == 0)[
                None, None, :, None]
            froz = torch.where(word_is0, seq_logprob[:, :, None, None],
                               FROZEN_SEA)
            total = torch.where(frozen[:, :, None, None], froz, total)
        if beam0_only:
            beam0 = (torch.arange(k, device=dev) == 0)[None, :, None, None]
            total = torch.where(beam0, total, -torch.inf)
        v2 = w.shape[-1] * 2
        sel_logprob, idx = top_k(total.reshape(batch, k * v2), k)
        return (sel_logprob,) + _split_flat(idx, v2)

    # ----- t = 0: single live beam ------------------------------------------
    with obs.span("beam.step"):
        zeros_bk = torch.zeros((batch * k,), dtype=torch.long, device=dev)
        (w_logp, g_logp), state = step_fn(state, zeros_bk, zeros_bk, True)
        vocab = w_logp.shape[-1]
        w = w_logp.reshape(batch, k, vocab)
        g = g_logp.reshape(batch, k, 2)
        seq_logprob, sel_beam, word, gate = joint_topk(
            torch.zeros((batch, k), device=dev), w, g, beam0_only=True)
        state = _gather_beam(state, sel_beam, batch, k)

        words = _history(seq_len, batch, k, dev, word, torch.long)
        gates = _history(seq_len, batch, k, dev, gate, torch.long)
        word_logps = _history(seq_len, batch, k, dev,
                              _record(w, sel_beam, word), torch.float32)
        gate_logps = _history(seq_len, batch, k, dev,
                              _record(g, sel_beam, gate), torch.float32)
        mask_w = torch.ones((batch, k), device=dev)
        mask_g = torch.ones((batch, k), device=dev)

    # ----- t >= 1 ------------------------------------------------------------
    for t in range(1, seq_len):
        with obs.span("beam.step"):
            (w_logp, g_logp), state = step_fn(
                state, word.reshape(-1), gate.reshape(-1), False)
            w = w_logp.reshape(batch, k, vocab)
            g = g_logp.reshape(batch, k, 2)

            # EOS masks from previously selected outputs (ref :228-229)
            mask_w = mask_w * (word != eos_word)
            mask_g = mask_g * (gate != eos_gate)
            mask_full = torch.clamp(mask_w + mask_g, 0.0, 1.0)
            seq_logprob, sel_beam, word, gate = joint_topk(
                seq_logprob, w, g, frozen=(mask_full == 0.0))

            state = _gather_beam(state, sel_beam, batch, k)
            mask_w = torch.gather(mask_w, 1, sel_beam)
            mask_g = torch.gather(mask_g, 1, sel_beam)
            hist = sel_beam[:, :, None].expand(-1, -1, seq_len)
            words = torch.gather(words, 1, hist)
            gates = torch.gather(gates, 1, hist)
            words[:, :, t] = word
            gates[:, :, t] = gate
            # (w * mask)[b, sel, word] == w[b, sel, word] * mask[b, sel]
            # with the masks already gathered along sel_beam
            word_logps[:, :, t] = _record(w, sel_beam, word) * mask_w
            gate_logps[:, :, t] = _record(g, sel_beam, gate) * mask_g

    # top_k leaves beams sorted by score desc (ref sorts again :279)
    return BeamResult(words, gates, word_logps, gate_logps, seq_logprob)


def _sort_by(keys, *tensors):
    perm = torch.sort(keys, dim=1, stable=True).indices
    return tuple(torch.gather(x, 1, perm) for x in tensors)


def beam_search_joint_candidates(step_fn: Callable, state, batch: int,
                                 beam_size: int, seq_len: int, eos_word: int,
                                 vocab_size: int, eos_gate: int = -1,
                                 with_state: bool = False, runner=None):
    """Candidate-based joint beam search: the selection of
    `beam_search_joint` without scoring the dense (beam x vocab x gate)
    space.

    `step_fn(state, prev_word, prev_gate, t0) ->
    ((cand_ids (rows, C), cand_wlp (rows, C), g_logp (rows, 2)), state)`
    returns per decode row a candidate word set that contains that row's
    contribution to the item's joint top-k: a normal row's top-k words, or
    a verb row's forced tense word plus the k lowest other ids at -1e6.

    Finished beams are frozen in candidate space (word 0 at the old score,
    a -999 sea on slots 1..C-1). Ties break as in the dense flat top-k, by
    the two keys (-score, flat virtual index beam*V*2 + word*2 + gate):
    JAX's two-key sort becomes a stable sort by the index, then a stable
    sort by the score's total-order key. The word and gate logprobs ride
    along as passengers; beam, word and gate come from the index.

    Every field of `state` is indexed by rows at each selection
    (`_gather_beam`), so a field that is no tensor follows the beams
    through its own `__getitem__`. Returns the `BeamResult`, and with
    `with_state` also the final state, (result, state)."""
    k = beam_size
    v2 = vocab_size * 2
    dev = state[0].device

    def select(seq_logprob, cand_ids, cand_wlp, g, frozen=None,
               beam0_only=False):
        b, kk, c = cand_ids.shape
        slot = torch.arange(c, device=dev)[None, None, :]
        if frozen is not None:
            cand_ids = torch.where(frozen[:, :, None], slot, cand_ids)
        score = (seq_logprob[:, :, None, None] + cand_wlp[:, :, :, None]
                 + g[:, :, None, :])                       # (B, K, C, 2)
        if frozen is not None:
            froz = torch.where(slot == 0, seq_logprob[:, :, None],
                               FROZEN_SEA)
            score = torch.where(frozen[:, :, None, None],
                                froz[:, :, :, None], score)
        if beam0_only:
            score = torch.where(
                (torch.arange(kk, device=dev) == 0)[None, :, None, None],
                score, -torch.inf)
        gate_ax = torch.arange(2, device=dev)[None, None, None, :]
        vidx = (torch.arange(kk, device=dev)[None, :, None, None] * v2
                + cand_ids[:, :, :, None] * 2 + gate_ax)   # (B, K, C, 2)
        n = kk * c * 2
        shape = score.shape
        flat_score = score.reshape(b, n)
        flat_vidx = vidx.reshape(b, n)
        flat_wlp = cand_wlp[:, :, :, None].expand(shape).reshape(b, n)
        flat_glp = g[:, :, None, :].expand(shape).reshape(b, n)
        # secondary key first, then the primary key, both stable
        flat_score, flat_vidx, flat_wlp, flat_glp = _sort_by(
            flat_vidx, flat_score, flat_vidx, flat_wlp, flat_glp)
        flat_score, flat_vidx, flat_wlp, flat_glp = _sort_by(
            ~total_order_key(flat_score), flat_score, flat_vidx, flat_wlp,
            flat_glp)
        sel_beam, word, gate = _split_flat(flat_vidx[:, :k], v2)
        return (flat_score[:, :k], sel_beam, word, gate, flat_wlp[:, :k],
                flat_glp[:, :k])

    def first(carry):
        state, = carry
        zeros_bk = torch.zeros((batch * k,), dtype=torch.long, device=dev)
        (c_ids, c_wlp, g_logp), state = step_fn(state, zeros_bk, zeros_bk,
                                                True)
        C = c_ids.shape[-1]
        (seq_logprob, sel_beam, word, gate, w_lp0, g_lp0) = select(
            torch.zeros((batch, k), device=dev), c_ids.reshape(batch, k, C),
            c_wlp.reshape(batch, k, C), g_logp.reshape(batch, k, 2),
            beam0_only=True)
        state = _gather_beam(state, sel_beam, batch, k)

        words = _history(seq_len, batch, k, dev, word, torch.long)
        gates = _history(seq_len, batch, k, dev, gate, torch.long)
        word_logps = _history(seq_len, batch, k, dev, w_lp0, torch.float32)
        gate_logps = _history(seq_len, batch, k, dev, g_lp0, torch.float32)
        mask_w = torch.ones((batch, k), device=dev)
        mask_g = torch.ones((batch, k), device=dev)
        return (state, word, gate, seq_logprob, mask_w, mask_g, words, gates,
                word_logps, gate_logps)

    def step(t, carry):
        (state, word, gate, seq_logprob, mask_w, mask_g, words, gates,
         word_logps, gate_logps) = carry
        (c_ids, c_wlp, g_logp), state = step_fn(
            state, word.reshape(-1), gate.reshape(-1), False)
        C = c_ids.shape[-1]
        mask_w = mask_w * (word != eos_word)
        mask_g = mask_g * (gate != eos_gate)
        mask_full = torch.clamp(mask_w + mask_g, 0.0, 1.0)
        (seq_logprob, sel_beam, word, gate, wlp_sel, glp_sel) = select(
            seq_logprob, c_ids.reshape(batch, k, C),
            c_wlp.reshape(batch, k, C), g_logp.reshape(batch, k, 2),
            frozen=(mask_full == 0.0))

        state = _gather_beam(state, sel_beam, batch, k)
        mask_w = torch.gather(mask_w, 1, sel_beam)
        mask_g = torch.gather(mask_g, 1, sel_beam)
        hist = sel_beam[:, :, None].expand(-1, -1, seq_len)
        words = torch.gather(words, 1, hist)
        gates = torch.gather(gates, 1, hist)
        words[:, :, t] = word
        gates[:, :, t] = gate
        word_logps[:, :, t] = wlp_sel * mask_w
        gate_logps[:, :, t] = glp_sel * mask_g
        return (state, word, gate, seq_logprob, mask_w, mask_g, words, gates,
                word_logps, gate_logps)

    run = runner or (lambda t, body, carry: body(carry))
    with obs.span("beam.step"):
        carry = run(0, first, (state,))
    for t in range(1, seq_len):
        with obs.span("beam.step"):
            carry = run(t, partial(step, t), carry)
    state, seq_logprob = carry[0], carry[3]
    res = BeamResult(*carry[6:], seq_logprob)
    return (res, state) if with_state else res
