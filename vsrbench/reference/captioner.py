"""The role-shift captioner in plain PyTorch (reference
`models/controllable_captioning.py`: `step` and `step_v`, and
`coco_scripts/train.py`'s XE loss), float32.

Parameters are nested dicts of tensors under the reference's module names,
in `torch.nn` layout (`Linear.weight` is (out, in), `LSTMCell` packs its
gates i, f, g, o). `cfg` is the configuration file's `captioner` group.

Three uses:

  * `judge_beams`: feeds the served beams' words and gates back through the
    step (teacher forcing along each served path) and measures how far
    each served choice and score lies from what this step gives;
  * `beam_search`: the joint (word x gate) beam search of its own (ref
    `CaptioningModel.beam_search` with `step_v`), whose beams the served
    ones are held to;
  * `xe_loss`, `xe_grads`, `xe_losses`, `adam_step`: the XE objective,
    its gradients (autograd, in blocks of rows), its value alone at given
    parameters, and Adam (Kingma and Ba, eps outside the root), for three
    steps from the same initial weights as the program.
"""
from __future__ import annotations

import math

import torch

VERB_SEA = -1e6          # logprob of every non-target word on a verb row
GATE_CHANGE = -1e3       # gate logprob of "stay" on a verb row


def _lin(p, x):
    y = x @ p["weight"].T
    return y + p["bias"] if "bias" in p else y


def _lstm(p, x, h, c):
    gates = (x @ p["weight_ih"].T + p["bias_ih"]
             + h @ p["weight_hh"].T + p["bias_hh"])
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def image_descriptor(det):
    """Mean of the detections that are not all zero (B, N, D) -> (B, D)."""
    mask = (det.sum(-1, keepdim=True) != 0).float()
    return det.sum(1) / mask.sum(1)


def step(p, cfg, state, it, det_curr, det_proj, det_mask, idesc):
    """One step. state (h1, c1, h2, c2); it (B,) input word; det_curr
    (B, M, D) the current region group, det_proj its att_va projection,
    det_mask (B, M) 1.0 where a region is not all zero. Returns (word
    logits (B, V), gate logprobs (B, 2), state)."""
    h1, c1, h2, c2 = state
    xt = p["embed"]["weight"][it]
    if cfg["h2_first_lstm"]:
        input_1 = torch.cat([h2, idesc, xt], 1)
    else:
        input_1 = torch.cat([idesc, xt], 1)
    s_gate = torch.sigmoid(_lin(p["W1_is"], input_1) + _lin(p["W1_hs"], h1))
    h1, c1 = _lstm(p["lstm_cell_1"], input_1, h1, c1)
    s_t = s_gate * torch.tanh(c1)
    fc_sentinel = _lin(p["s_fc"], s_t)                          # (B, D)

    ha = _lin(p["att_ha"], h1)                                  # (B, A)
    det_w = _lin(p["att_a"], torch.tanh(det_proj + ha[:, None]))  # (B, M, 1)
    sent_w = _lin(p["att_s"], torch.tanh(_lin(p["att_sa"], s_t) + ha))
    att = torch.softmax(torch.cat([sent_w[:, None], det_w], 1), 1)
    sent_mask = (fc_sentinel.sum(-1, keepdim=True) != 0).float()
    att = torch.cat([sent_mask[:, :, None], det_mask[:, :, None]], 1) * att
    att = att / att.sum(1, keepdim=True)
    att_det = (torch.cat([fc_sentinel[:, None], det_curr], 1) * att).sum(1)

    parts = [h1, att_det] + ([idesc] if cfg["img_second_lstm"] else [])
    h2, c2 = _lstm(p["lstm_cell_2"], torch.cat(parts, 1), h2, c2)
    logits = _lin(p["out_fc"], h2)

    g_gate = torch.sigmoid(_lin(p["W1_ig"], input_1) + _lin(p["W1_hg"], h1))
    g_t = g_gate * torch.tanh(c1)
    gate_w = _lin(p["att_g"], torch.tanh(_lin(p["att_ga"], g_t) + ha))
    det_w_sum = (det_mask[:, :, None] * det_w).sum(1)
    gate_logp = torch.log_softmax(torch.cat([gate_w, det_w_sum], 1), -1)
    return logits, gate_logp, (h1, c1, h2, c2)


def verb_kth(k, vocab):
    """The K-th best joint logprob among a verb row's children: the target
    with each gate, then every other word (the sea) with each gate."""
    others = min(k, vocab - 1)
    joint = sorted([0.0, GATE_CHANGE] + [VERB_SEA] * others
                   + [VERB_SEA + GATE_CHANGE] * others, reverse=True)
    return joint[k - 1]


def zero_state(cfg, rows, device):
    z = torch.zeros((rows, cfg["rnn_size"]), device=device)
    return (z, z, z, z)


# ---------------------------------------------------------------------------
# Served beams, judged by teacher forcing
# ---------------------------------------------------------------------------

@torch.no_grad()
def judge_beams(p, cfg, det, recons, verb_lists, tense_ids, served,
                eos_word, k=None):
    """How far served beams lie from this step, per job.

    det (P, N, D) detections; recons (P, L, M, D) the jobs' region groups;
    verb_lists (P, L) verb ids or -1; tense_ids (n_verbs + 1, Kt) word ids
    of each verb's tenses, -1 padded; served: dict of the program's
    `words`, `gates` (P, K, T) int, `word_logps`, `gate_logps` (P, K, T)
    and `scores` (P, K).

    Along each served path (BOS first, the region pointer moved by each
    served gate and clipped to the last group) every step is recomputed
    here, and three gaps are taken, in nats:

      * selection: a served (word, gate) must be one of the K best children
        of its prefix (the joint top-K over an item's beams takes at most
        K children of any one prefix, each better than every child left
        out), so the gap is how far its joint logprob lies below the K-th
        best here; on a verb row the served word must be a tense of the
        verb, and the gap is how far its logit lies below the best tense's;
      * record: the program's recorded word and gate logprobs of the last
        step against this step's (the word's masked after the path's first
        EOS word). The records of a step belong to the beam slot a child
        was put in at that step (ref CaptioningModel.py:273), not to the
        final paths, so only the last step's lie on the served paths;
      * score: the program's beam score against the sum of this step's
        joint logprobs along the path, relative to max(1, |score|); and
        the largest rise of the served scores from one beam to the next
        (beams come best first), relative likewise.

    Returns a dict of (P,) tensors, the worst of each gap over a job's
    beams and steps, and under "paths" this step's own records along the
    served paths, in the served dict's form (the control reads them)."""
    words, gates = served["words"].long(), served["gates"].long()
    n_jobs, kk, t_len = words.shape
    k = k or kk
    dev = det.device
    rows = n_jobs * kk
    item = torch.arange(rows, device=dev) // kk
    words, gates = words.reshape(rows, t_len), gates.reshape(rows, t_len)
    rec_w = served["word_logps"].reshape(rows, t_len).float()
    rec_g = served["gate_logps"].reshape(rows, t_len).float()
    n_groups = recons.shape[1]
    idesc = image_descriptor(det)[item]
    proj = _lin(p["att_va"], recons)                      # (P, L, M, A)
    gmask = (recons.sum(-1) != 0).float()                 # (P, L, M)
    state = zero_state(cfg, rows, dev)
    ctrl = torch.zeros((rows,), dtype=torch.long, device=dev)
    prev = torch.full((rows,), cfg["bos_idx"], dtype=torch.long, device=dev)
    score = torch.zeros((rows,), device=dev)
    alive = torch.ones((rows,), device=dev)
    sel_gap = torch.zeros((rows,), device=dev)
    rec_gap = torch.zeros((rows,), device=dev)
    own_w, own_g = [], []
    for t in range(t_len):
        if t:
            ctrl = (ctrl + gates[:, t - 1]).clamp(0, n_groups - 1)
            prev = words[:, t - 1]
        logits, glp, state = step(p, cfg, state, prev, recons[item, ctrl],
                                  proj[item, ctrl], gmask[item, ctrl], idesc)
        wlp = torch.log_softmax(logits, -1)
        w, g = words[:, t], gates[:, t]
        verb = verb_lists[item, ctrl]
        is_verb = verb != -1
        # normal rows
        joint = (wlp[:, :, None] + glp[:, None, :]).reshape(rows, -1)
        kth = joint.topk(k, -1).values[:, -1]
        j_norm = wlp.gather(1, w[:, None])[:, 0] + glp.gather(1, g[:, None])[:, 0]
        gap_norm = (kth - j_norm).clamp_min(0)
        # verb rows: the target is the verb's best tense here (word 0 for a
        # verb without tenses), at logprob 0; every other word is the sea
        cand = tense_ids[verb.clamp(0, tense_ids.shape[0] - 1)]
        valid = cand >= 0
        cand_logit = torch.where(
            valid, logits.gather(1, cand.clamp(0, logits.shape[1] - 1)),
            -math.inf)
        has_tense = valid.any(1)
        is_tgt = torch.where(has_tense, ((cand == w[:, None]) & valid).any(1),
                             w == 0)
        tie_gap = torch.where(
            is_tgt & has_tense,
            cand_logit.amax(1) - logits.gather(1, w[:, None])[:, 0], 0.0)
        w_verb = torch.where(is_tgt, 0.0, VERB_SEA)
        g_verb = torch.where(g == 0, GATE_CHANGE, 0.0)
        gap_verb = torch.maximum(
            tie_gap, (verb_kth(k, logits.shape[1]) - (w_verb + g_verb))
            .clamp_min(0))
        w_lp = torch.where(is_verb, w_verb,
                           wlp.gather(1, w[:, None])[:, 0])
        g_lp = torch.where(is_verb, g_verb, glp.gather(1, g[:, None])[:, 0])
        sel_gap = torch.maximum(sel_gap, torch.where(is_verb, gap_verb,
                                                     gap_norm))
        if t == t_len - 1:
            rec_gap = torch.maximum(
                (rec_w[:, t] - w_lp * alive).abs(), (rec_g[:, t] - g_lp).abs())
        score = (score + w_lp) + g_lp
        own_w.append(w_lp * alive)
        own_g.append(g_lp)
        alive = alive * (w != eos_word).float()
    got = served["scores"].reshape(rows).float()
    score_gap = (got - score).abs() / score.abs().clamp_min(1.0)
    per_job = lambda x: x.reshape(n_jobs, kk).amax(1)  # noqa: E731
    by_job = got.reshape(n_jobs, kk)
    rise = ((by_job[:, 1:] - by_job[:, :-1]).clamp_min(0)
            / by_job[:, :-1].abs().clamp_min(1.0))
    score_gap = torch.maximum(
        per_job(score_gap),
        rise.amax(1) if kk > 1 else torch.zeros_like(by_job[:, 0]))
    paths = {"words": served["words"], "gates": served["gates"],
             "word_logps": torch.stack(own_w, 1).reshape(n_jobs, kk, t_len),
             "gate_logps": torch.stack(own_g, 1).reshape(n_jobs, kk, t_len),
             "scores": score.reshape(n_jobs, kk)}
    return {"selection": per_job(sel_gap), "record": per_job(rec_gap),
            "score": score_gap, "paths": paths}


@torch.no_grad()
def beam_search(p, cfg, det, recons, verb_lists, tense_ids, k):
    """The joint (word x gate) beam search with verb substitution, of this
    step (ref `CaptioningModel.beam_search` over `step_v`).

    Inputs as `judge_beams`'. At t = 0 only beam 0 is live; at every step
    the K best of an item's K x V x 2 children (score + word logprob +
    gate logprob, summed in that order) survive, the lowest flat index
    (beam, word, gate) first among equal scores. A verb row's word
    logprobs are 0 at the verb's best tense here (word 0 for a verb
    without tenses) and VERB_SEA elsewhere, its gate logprobs (GATE_CHANGE,
    0). Beams are never frozen: the eval path gives the gate no EOS.

    Returns (words, gates (P, K, T), scores (P, K) best first, margin
    (P,)): the least gap, over the steps, between the K-th and the
    (K+1)-th best child of an item, relative to max(1, |K-th|). Where it
    is small the two may trade places under round-off, and from there on
    another sound search may keep other beams."""
    n_jobs, t_len = det.shape[0], cfg["seq_len"]
    vocab, dev = cfg["vocab_size"], det.device
    rows = n_jobs * k
    item = torch.arange(rows, device=dev) // k
    n_groups = recons.shape[1]
    idesc = image_descriptor(det)[item]
    proj = _lin(p["att_va"], recons)
    gmask = (recons.sum(-1) != 0).float()
    state = zero_state(cfg, rows, dev)
    ctrl = torch.zeros((rows,), dtype=torch.long, device=dev)
    prev = torch.full((rows,), cfg["bos_idx"], dtype=torch.long, device=dev)
    seq = torch.zeros((n_jobs, k), device=dev)
    words = torch.zeros((n_jobs, k, t_len), dtype=torch.long, device=dev)
    gates = torch.zeros_like(words)
    margin = torch.full((n_jobs,), math.inf, device=dev)
    verb_gate = torch.tensor([GATE_CHANGE, 0.0], device=dev)
    for t in range(t_len):
        logits, glp, state = step(p, cfg, state, prev, recons[item, ctrl],
                                  proj[item, ctrl], gmask[item, ctrl], idesc)
        wlp = torch.log_softmax(logits, -1)
        verb = verb_lists[item, ctrl]
        is_verb = (verb != -1)[:, None]
        cand = tense_ids[verb.clamp(0, tense_ids.shape[0] - 1)]
        valid = cand >= 0
        cand_logit = torch.where(
            valid, logits.gather(1, cand.clamp(0, vocab - 1)), -math.inf)
        target = torch.where(valid.any(1), cand.gather(
            1, cand_logit.argmax(1, keepdim=True))[:, 0], 0)
        w_verb = torch.full((rows, vocab), VERB_SEA, device=dev)
        w_verb.scatter_(1, target[:, None], 0.0)
        w_row = torch.where(is_verb, w_verb, wlp)
        g_row = torch.where(is_verb, verb_gate, glp)
        total = ((seq[:, :, None, None] + w_row.reshape(n_jobs, k, vocab, 1))
                 + g_row.reshape(n_jobs, k, 1, 2))
        if t == 0:
            total[:, 1:] = -math.inf
        vals, idx = torch.sort(total.reshape(n_jobs, -1), dim=1,
                               descending=True, stable=True)
        kth, nxt = vals[:, k - 1], vals[:, k]
        margin = torch.minimum(margin, (kth - nxt) / kth.abs().clamp_min(1.0))
        seq, idx = vals[:, :k], idx[:, :k]
        beam = idx // (2 * vocab)
        word, gate = (idx % (2 * vocab)) // 2, idx % 2
        pick = (torch.arange(n_jobs, device=dev)[:, None] * k
                + beam).reshape(-1)
        state = tuple(x[pick] for x in state)
        hist = beam[:, :, None].expand(-1, -1, t_len)
        words = words.gather(1, hist)
        gates = gates.gather(1, hist)
        words[:, :, t], gates[:, :, t] = word, gate
        prev = word.reshape(-1)
        ctrl = (ctrl[pick] + gate.reshape(-1)).clamp(0, n_groups - 1)
    return words, gates, seq, margin


# ---------------------------------------------------------------------------
# XE training
# ---------------------------------------------------------------------------

def expand_groups(det, ids):
    """Region groups from compact region ids: det (B, N, D), ids (B, M)
    with -1 for no region -> (B, M, D), zero rows where ids is -1."""
    b, n, _ = det.shape
    feats = det[torch.arange(b, device=det.device)[:, None],
                ids.clamp(0, n - 1)]
    return torch.where((ids >= 0)[..., None], feats, 0.0)


def xe_loss(p, cfg, det, caps, ids, gate_tgt, n_rows, n_gate):
    """The XE objective's share of rows of a batch (ref train.py:103-110):
    word NLL of captions[:, t + 1] at step t over n_rows * (T - 1) terms,
    plus 4 x the gate NLL of gate_tgt[:, t] over the batch's n_gate targets
    that are not -1. Step t reads word captions[:, t] and group ids[:, t].
    Returns (loss share, word share, gate share)."""
    b, t_len = caps.shape
    idesc = image_descriptor(det)
    state = zero_state(cfg, b, det.device)
    w_sum = det.new_zeros(())
    g_sum = det.new_zeros(())
    for t in range(t_len):
        groups = expand_groups(det, ids[:, t])
        logits, glp, state = step(p, cfg, state, caps[:, t], groups,
                                  _lin(p["att_va"], groups),
                                  (groups.sum(-1) != 0).float(), idesc)
        if t < t_len - 1:
            wlp = torch.log_softmax(logits, -1)
            w_sum = w_sum + wlp.gather(1, caps[:, t + 1, None]).sum()
        tgt = gate_tgt[:, t]
        g_sum = g_sum + (glp.gather(1, tgt.clamp(0, 1)[:, None])[:, 0]
                         * (tgt != -1)).sum()
    loss_w = -w_sum / (n_rows * (t_len - 1))
    loss_g = -g_sum / n_gate
    return loss_w + 4.0 * loss_g, loss_w, loss_g


def flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = prefix + key
        if isinstance(val, dict):
            out.update(flatten(val, name + "."))
        else:
            out[name] = val
    return out


def xe_grads(params, cfg, det, caps, ids, gate_tgt, block):
    """(word loss, gate loss, {leaf name: gradient}) of the whole batch's
    XE objective, taken over blocks of `block` rows so that it fits."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten(params).items()}
    tree = unflatten(flat)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    b = caps.shape[0]
    n_gate = float((gate_tgt != -1).sum())
    loss_w = loss_g = 0.0
    for lo in range(0, b, block):
        sl = slice(lo, lo + block)
        loss, lw, lg = xe_loss(tree, cfg, det[sl], caps[sl], ids[sl],
                               gate_tgt[sl], b, n_gate)
        got = torch.autograd.grad(loss, list(flat.values()),
                                  allow_unused=True)
        for (name, _), gr in zip(flat.items(), got):
            if gr is not None:
                grads[name] += gr
        loss_w += float(lw.detach())
        loss_g += float(lg.detach())
    return loss_w, loss_g, grads


@torch.no_grad()
def xe_losses(params, cfg, det, caps, ids, gate_tgt, block):
    """(word loss, gate loss) of the whole batch's XE objective at
    `params`, over blocks of `block` rows, as `xe_grads` takes them."""
    b = caps.shape[0]
    n_gate = float((gate_tgt != -1).sum())
    loss_w = loss_g = 0.0
    for lo in range(0, b, block):
        sl = slice(lo, lo + block)
        _, lw, lg = xe_loss(params, cfg, det[sl], caps[sl], ids[sl],
                            gate_tgt[sl], b, n_gate)
        loss_w += float(lw)
        loss_g += float(lg)
    return loss_w, loss_g


def unflatten(flat):
    tree = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def _f32(x):
    return torch.tensor(x, dtype=torch.float32).item()


def adam_step(flat, grads, m, v, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step (Kingma and Ba; torch.optim.Adam's defaults, eps added
    outside the root of the bias-corrected second moment) on flat dicts;
    returns the new (params, m, v). Float32 step math: the rates, 1 - each
    rate and the bias corrections are float32 numbers (1 - f32(0.999) is
    not 0.001), as a float32 optimizer holds them."""
    lr, b1, b2, eps = (_f32(x) for x in (lr, b1, b2, eps))
    c1, c2 = _f32(1 - b1), _f32(1 - b2)
    bc1, bc2 = _f32(1 - _f32(b1 ** count)), _f32(1 - _f32(b2 ** count))
    new_p, new_m, new_v = {}, {}, {}
    for name, par in flat.items():
        g = grads[name]
        new_m[name] = b1 * m[name] + c1 * g
        new_v[name] = b2 * v[name] + c2 * g * g
        new_p[name] = par - lr * (new_m[name] / bc1) / (
            torch.sqrt(new_v[name] / bc2) + eps)
    return new_p, new_m, new_v
