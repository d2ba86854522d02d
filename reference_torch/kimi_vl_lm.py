"""Kimi-VL-A3B's language model as a caption decoder, in plain PyTorch.

The plain reference of `vsrcic_tpu_torch/models/kimi_vl.py`: float32 math
(the caller turns TF32 off), no kernel, cache or batching trick, written
from the published equations (moonshotai/Kimi-VL-A3B-Instruct's
`config.json`, the DeepSeek-V3 block of the HF modelling code) and the
captioning wiring the configuration states. It imports nothing but torch.

Weights are the program's tree (bf16 on the card), upcast to f32 one layer
at a time (`upcast`): an f32 layer (2.3 GB at the published widths) is all
this code holds beside them.

  * `forward`: the full forward of each path, its prefix tokens (the
    projected detections, padding masked) and caption inputs (the word
    embedding plus the group's control token) in one causal sequence, to
    the final normed hidden at the caption positions; optionally along
    given expert choices (`routes`), measuring how far each lies below
    this router's 6th best;
  * `judge_beams`: the program's served beams teacher-forced through
    `forward` along their own expert choices, and the gaps of every
    served log-prob, choice and score;
  * `judge_cut`: the beams live at one step, rebuilt from the program's
    parent pointers and teacher-forced likewise, and how far the beams
    the step kept lie below the K best of all their children (the joint
    top-K cut);
  * `beam_search`: the joint (word x gate) beam search of its own. The
    prefix is worked once a job (a causal prefix does not depend on the
    caption) and the caption anew at every step.
"""
from __future__ import annotations

import math

import torch

VERB_SEA = -1e6          # logprob of every non-target word on a verb row
GATE_CHANGE = -1e3       # gate logprob of "stay" on a verb row


def upcast(tree):
    """A dict of tensors (one layer, or a group) in float32."""
    return {k: upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """RoPE of the HF DeepSeek-V3 modelling code: the last dim's
    interleaved pairs de-interleaved (evens, then odds), then
    x cos + rotate_half(x) sin. pos broadcasts against x[..., 0]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float()
                           / d))
    f = pos.float()[..., None] * inv
    cos, sin = torch.cat([f, f], -1).cos(), torch.cat([f, f], -1).sin()
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def swiglu(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, -1)
    return (torch.nn.functional.silu(g) * u) @ down.T


def projector(w, feats):
    p = upcast(w["proj"])
    x = feats.float() @ p["fc1"]["weight"].T + p["fc1"]["bias"]
    x = torch.nn.functional.gelu(x)
    return x @ p["fc2"]["weight"].T + p["fc2"]["bias"]


def control_tokens(w, groups):
    """(P, L, M, D) region groups -> (P, L, H): the mean of each group's
    projected regions that are not all zero (0 for an empty group)."""
    mask = (groups.float().sum(-1) != 0).float()
    tok = projector(w, groups)
    return ((tok * mask[..., None]).sum(2)
            / mask.sum(2, keepdim=True).clamp_min(1.0))


def attention(lp, cfg, x, pos, ok, past=None):
    """Expanded-form MLA of tokens x (S, T, H) at positions pos (S, T);
    ok (S, T, T') bool: which keys each query may see, the past's first.
    past: (k, v) (S, N, heads, 192 / 128) of earlier tokens. Returns the
    output and this call's (k, v)."""
    nh, dn, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                  cfg["v_head_dim"])
    dq = dn + cfg["qk_rope_head_dim"]
    c = cfg["kv_lora_rank"]
    q = (x @ lp["q_proj"].T).unflatten(-1, (nh, dq))
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos[..., None],
                                     cfg["rope_theta"])], -1)
    kva = x @ lp["kv_a"].T
    c_kv = rms_norm(kva[..., :c], lp["kv_norm"], cfg["rms_norm_eps"])
    k_pe = rope(kva[..., c:], pos, cfg["rope_theta"])
    kv = (c_kv @ lp["kv_b"].T).unflatten(-1, (nh, dn + dv))
    k = torch.cat([kv[..., :dn], k_pe[..., None, :].expand(
        *k_pe.shape[:-1], nh, k_pe.shape[-1])], -1)
    v = kv[..., dn:]
    kk, vv = (k, v) if past is None else (torch.cat([past[0], k], 1),
                                          torch.cat([past[1], v], 1))
    s = torch.einsum("sqhd,skhd->shqk", q, kk) / math.sqrt(dq)
    s = s.masked_fill(~ok[:, None], -math.inf)
    o = torch.einsum("shqk,skhd->sqhd", torch.softmax(s, -1), vv)
    return o.flatten(-2) @ lp["o_proj"].T, (k, v)


def float8(x):
    """x through float8 e4m3 with a scale a row (its largest magnitude to
    448), back in f32: the control's expert inputs."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def moe(lp, cfg, x, forced=None):
    """Routed and shared experts over tokens x (T, H). forced (T, 6): the
    experts to take (else this router's top 6 of s + b_corr). Returns
    (y, gap (T,), the experts taken (T, 6)): gap, how far the chosen
    experts' s + b_corr lie below the 6th best here, the worst of each
    token's. With cfg["expert_inputs"] "float8_e4m3fn" (the control) every
    expert product takes its inputs, the activations and the weights,
    through `float8`."""
    k, n_exp = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    s = torch.sigmoid(x @ lp["router"].T)
    choice = s + lp["router_bias"]
    top = choice.topk(k, -1)
    idx = top.indices if forced is None else forced.long()
    gap = (top.values[:, -1:] - choice.gather(1, idx)).clamp_min(0).amax(1)
    wt = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * cfg["routed_scaling_factor"]
    q = float8 if cfg.get("expert_inputs") == "float8_e4m3fn" else (
        lambda t: t)

    def expert(t, gate_up, down):
        g, u = (q(t) @ q(gate_up).T).chunk(2, -1)
        return q(torch.nn.functional.silu(g) * u) @ q(down).T

    y = expert(x, lp["shared_gate_up"], lp["shared_down"])
    for e in range(n_exp):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            out = expert(x[tok], lp["experts_gate_up"][e],
                         lp["experts_down"][e])
            y = y.index_add(0, tok, out * wt[tok, slot, None])
    return y, gap, idx


def layers(w, cfg, x, pos, ok, past=None, forced=None, real=None,
           keep=False):
    """Every layer over tokens x (S, T, H). past: a list of each layer's
    (k, v) of earlier tokens (S rows). forced (S, T, L_moe, 6): expert
    choices; real (S, T) bool: the tokens whose route gaps count. Returns
    (the final normed hidden, route gap (S,), each layer's (k, v) if
    `keep`, the experts taken (S, T, L_moe, 6))."""
    s_, t_ = x.shape[:2]
    gap = torch.zeros((s_,), device=x.device)
    kept, taken = [], []
    moe_i = 0
    for i, lp in enumerate(w["layers"]):
        lp = upcast(lp)
        a, kv = attention(lp, cfg, rms_norm(x, lp["attn_norm"],
                                            cfg["rms_norm_eps"]),
                          pos, ok, None if past is None else past[i])
        if keep:
            kept.append(kv)
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg["rms_norm_eps"]).reshape(
            s_ * t_, -1)
        if "router" in lp:
            f = None if forced is None else forced[:, :, moe_i].reshape(
                s_ * t_, -1)
            y, g, idx = moe(lp, cfg, h, f)
            taken.append(idx.reshape(s_, t_, -1))
            g = g.reshape(s_, t_)
            if real is not None:
                g = torch.where(real, g, 0.0)
            gap = torch.maximum(gap, g.amax(1))
            moe_i += 1
        else:
            y = swiglu(h, lp["gate_up"], lp["down"])
        x = x + y.reshape(s_, t_, -1)
        del lp
    return (rms_norm(x, w["norm"].float(), cfg["rms_norm_eps"]), gap, kept,
            torch.stack(taken, 2))


def prefix_of(w, dets):
    """Detections (P, N, D) -> (tokens (P, N, H), real (P, N) bool,
    positions (P, N))."""
    real = dets.float().sum(-1) != 0
    tok = torch.where(real[..., None], projector(w, dets), 0.0)
    return tok, real, (real.long().cumsum(1) - 1).clamp_min(0)


def causal(real_prefix, t_len):
    """(S, N + T, N + T) bool: a token sees itself and the real prefix
    tokens and caption tokens at or before it."""
    s_, n = real_prefix.shape
    m = n + t_len
    ar = torch.arange(m, device=real_prefix.device)
    live = torch.cat([real_prefix, torch.ones((s_, t_len), dtype=torch.bool,
                                              device=real_prefix.device)], 1)
    return (((ar[:, None] >= ar[None, :]) & live[:, None, :])
            | (ar[:, None] == ar[None, :]))


def caption_inputs(w, cfg, words, gates, ctrl_tok, item):
    """Each path's caption inputs: step t reads word t - 1 (BOS first) and
    the control token of its group, whose pointer starts at 0 and moves by
    each earlier gate, clipped to the last group. words, gates (S, T);
    ctrl_tok (P, L, H); item (S,) each path's job. -> (S, T, H)."""
    s_, t_len = words.shape
    prev = torch.cat([torch.full((s_, 1), cfg["bos_idx"], device=words.device,
                                 dtype=torch.long), words[:, :-1]], 1)
    step = torch.cat([torch.zeros((s_, 1), dtype=torch.long,
                                  device=words.device), gates[:, :-1]], 1)
    ctrl = torch.zeros((s_,), dtype=torch.long, device=words.device)
    ptrs = []
    for t in range(t_len):
        ctrl = (ctrl + step[:, t]).clamp(0, ctrl_tok.shape[1] - 1)
        ptrs.append(ctrl)
    ptr = torch.stack(ptrs, 1)
    return w["embed"][prev].float() + ctrl_tok[item[:, None], ptr], ptr


def forward(w, cfg, dets, words, gates, ctrl_tok, item, routes=None,
            prefix_routes=None):
    """The full forward of S paths: (final normed hidden at the caption
    positions (S, T, H), group pointers (S, T), route gap (S,)). dets
    (P, N, D); words, gates (S, T) the paths' choices (step t's input is
    word t - 1); ctrl_tok (P, L, H); item (S,) each path's job; routes
    (S, T, L_moe, 6) and prefix_routes (P, N, L_moe, 6): the expert
    choices to take (both, or neither). Also returns the experts taken
    (S, N + T, L_moe, 6)."""
    tok, real, pos = prefix_of(w, dets)
    t_len = words.shape[1]
    x_cap, ptr = caption_inputs(w, cfg, words, gates, ctrl_tok, item)
    n_real = real.sum(1)[item]
    x = torch.cat([tok[item], x_cap], 1)
    p_all = torch.cat([pos[item], n_real[:, None] + torch.arange(
        t_len, device=dets.device)], 1)
    forced = None
    if routes is not None:
        forced = torch.cat([prefix_routes[item], routes], 1)
    live = torch.cat([real[item], torch.ones_like(words, dtype=torch.bool)],
                     1)
    h, gap, _, taken = layers(w, cfg, x, p_all, causal(real[item], t_len),
                              None, forced, live)
    return h[:, -t_len:], ptr, gap, taken


def heads(w, h):
    """Word logits (S, V) and gate log-probs (S, 2) of final hiddens."""
    g = w["gate_head"]
    glp = torch.log_softmax(h @ g["weight"].float().T + g["bias"].float(), -1)
    return h @ w["lm_head"].float().T, glp


def verb_kth(k, vocab):
    """The K-th best joint logprob among a verb row's children."""
    others = min(k, vocab - 1)
    joint = sorted([0.0, GATE_CHANGE] + [VERB_SEA] * others
                   + [VERB_SEA + GATE_CHANGE] * others, reverse=True)
    return joint[k - 1]


def child_rows(logits, glp, verb, tense_ids):
    """A step's children as the joint beam scores them: (word log-probs
    (S, V), gate log-probs (S, 2)). A verb row's words are 0 at the verb's
    best tense here (word 0 for a verb without tenses) and VERB_SEA
    elsewhere, its gates (GATE_CHANGE, 0)."""
    s_, vocab = logits.shape
    cand = tense_ids[verb.clamp(0, tense_ids.shape[0] - 1)]
    valid = cand >= 0
    cand_logit = torch.where(
        valid, logits.gather(1, cand.clamp(0, vocab - 1)), -math.inf)
    target = torch.where(valid.any(1), cand.gather(
        1, cand_logit.argmax(1, keepdim=True))[:, 0], 0)
    w_verb = torch.full((s_, vocab), VERB_SEA, device=logits.device)
    w_verb.scatter_(1, target[:, None], 0.0)
    is_verb = (verb != -1)[:, None]
    verb_gate = torch.tensor([GATE_CHANGE, 0.0], device=logits.device)
    return (torch.where(is_verb, w_verb, torch.log_softmax(logits, -1)),
            torch.where(is_verb, verb_gate, glp))


def served_child(wlp, glp, verb, tense_ids, wd, g):
    """The joint log-probs (word, gate) (S,) of the children (wd, g) of
    rows with word log-probs wlp (S, V) and gate log-probs glp (S, 2); on
    a verb row any of the verb's tenses scores 0 (word 0 without tenses;
    which tense is the best is `judge_beams`' tie check)."""
    cand = tense_ids[verb.clamp(0, tense_ids.shape[0] - 1)]
    valid = cand >= 0
    is_tgt = torch.where(valid.any(1), ((cand == wd[:, None]) & valid).any(1),
                         wd == 0)
    is_verb = verb != -1
    w_lp = torch.where(is_verb, torch.where(is_tgt, 0.0, VERB_SEA),
                       wlp.gather(1, wd[:, None])[:, 0])
    g_lp = torch.where(is_verb, torch.where(g == 0, GATE_CHANGE, 0.0),
                       glp.gather(1, g[:, None])[:, 0])
    return w_lp, g_lp


@torch.no_grad()
def judge_beams(w, cfg, dets, recons, verb_lists, tense_ids, served,
                eos_word):
    """How far the program's served beams lie from this model, per job.

    dets (P, N, D); recons (P, L, M, D); verb_lists (P, L) verb ids or
    -1; tense_ids (n_verbs + 1, Kt) word ids, -1 padded; served: the
    program's `words`, `gates` (P, K, T), `word_logps`, `gate_logps` (P, K,
    T), `scores` (P, K), and along each final path what its decode
    computed: `head` (P, K, T, k + 3) (its top-k logits, lse, gate
    log-probs), `head_ids` (P, K, T, k), `routes` (P, K, T, L_moe, 6), and
    `prefix_routes` (P, N, L_moe, 6).

    Each path is run through `forward` along the program's expert
    choices (along this router's own where `served` has no `routes`).
    Gaps, in nats:

      * route: how far a chosen expert's s + b_corr lies below the 6th
        best here, over every real token and layer of the path;
      * logit: the served word's log-prob (normal rows), the lse and both
        gate log-probs the program computed at each step, against this
        model's;
      * beam: the worst of: a served (word, gate) below the K-th best
        child of its prefix here (verb rows: the served tense's logit
        below the best tense's); the last step's records; the score
        against the path's summed log-probs here and the largest rise of
        the scores from one beam to the next, both relative to
        max(1, |score|).

    Returns {"route", "logit", "beam": (P,)} and under "paths" what this
    model computes along the served paths, in `served`'s form (the control
    stands it in the program's place)."""
    words, gates = served["words"].long(), served["gates"].long()
    n_jobs, kk, t_len = words.shape
    s_ = n_jobs * kk
    dev = dets.device
    item = torch.arange(s_, device=dev) // kk
    words, gates = words.reshape(s_, t_len), gates.reshape(s_, t_len)
    ctrl_tok = control_tokens(w, recons)
    routes = served.get("routes")
    if routes is not None:
        routes = routes.reshape(s_, t_len, *routes.shape[3:])
    h, ptr, route_gap, taken = forward(
        w, cfg, dets, words, gates, ctrl_tok, item, routes,
        served["prefix_routes"] if routes is not None else None)
    head = served["head"].reshape(s_, t_len, -1).float()
    head_ids = served["head_ids"].reshape(s_, t_len, -1).long()
    k = head_ids.shape[-1]
    rec_w = served["word_logps"].reshape(s_, t_len).float()
    rec_g = served["gate_logps"].reshape(s_, t_len).float()
    score = torch.zeros((s_,), device=dev)
    alive = torch.ones((s_,), device=dev)
    sel_gap = torch.zeros((s_,), device=dev)
    logit_gap = torch.zeros((s_,), device=dev)
    rec_gap = torch.zeros((s_,), device=dev)
    own_w, own_g, own_head, own_ids = [], [], [], []
    for t in range(t_len):
        logits, glp = heads(w, h[:, t])
        lse = torch.logsumexp(logits, -1)
        # in the program's form: the served word's logit first, then the
        # top k - 1
        top = logits.topk(k - 1, -1)
        wd = words[:, t]
        own_head.append(torch.cat([logits.gather(1, wd[:, None]), top.values,
                                   lse[:, None], glp], 1))
        own_ids.append(torch.cat([wd[:, None], top.indices], 1).int())
        wlp = logits - lse[:, None]
        wd, g = words[:, t], gates[:, t]
        verb = verb_lists[item, ptr[:, t]]
        is_verb = verb != -1
        # what the program computed at this step of the path
        p_vals, p_lse, p_glp = head[:, t, :k], head[:, t, k], head[:, t, k + 1:]
        hit = head_ids[:, t] == wd[:, None]
        p_wlp = p_vals.gather(1, hit.float().argmax(1, keepdim=True))[:, 0]
        # a normal row's served word must be one the program scored
        d_w = torch.where(is_verb, 0.0, torch.where(
            hit.any(1), (p_wlp - p_lse - wlp.gather(1, wd[:, None])[:, 0])
            .abs(), math.inf))
        logit_gap = torch.maximum(logit_gap, torch.maximum(
            torch.maximum(d_w, (p_lse - lse).abs()),
            (p_glp - glp).abs().amax(1)))
        # normal rows: one of the prefix's K best children
        joint = (wlp[:, :, None] + glp[:, None, :]).reshape(s_, -1)
        kth = joint.topk(kk, -1).values[:, -1]
        j_norm = wlp.gather(1, wd[:, None])[:, 0] + glp.gather(1, g[:, None])[:, 0]
        gap_norm = (kth - j_norm).clamp_min(0)
        # verb rows: the verb's best tense here, at logprob 0
        cand = tense_ids[verb.clamp(0, tense_ids.shape[0] - 1)]
        valid = cand >= 0
        cand_logit = torch.where(
            valid, logits.gather(1, cand.clamp(0, logits.shape[1] - 1)),
            -math.inf)
        has_tense = valid.any(1)
        is_tgt = torch.where(has_tense, ((cand == wd[:, None]) & valid).any(1),
                             wd == 0)
        tie_gap = torch.where(
            is_tgt & has_tense,
            cand_logit.amax(1) - logits.gather(1, wd[:, None])[:, 0], 0.0)
        w_verb = torch.where(is_tgt, 0.0, VERB_SEA)
        g_verb = torch.where(g == 0, GATE_CHANGE, 0.0)
        gap_verb = torch.maximum(
            tie_gap, (verb_kth(kk, logits.shape[1]) - (w_verb + g_verb))
            .clamp_min(0))
        w_lp = torch.where(is_verb, w_verb, wlp.gather(1, wd[:, None])[:, 0])
        g_lp = torch.where(is_verb, g_verb, glp.gather(1, g[:, None])[:, 0])
        sel_gap = torch.maximum(sel_gap, torch.where(is_verb, gap_verb,
                                                     gap_norm))
        if t == t_len - 1:
            rec_gap = torch.maximum((rec_w[:, t] - w_lp * alive).abs(),
                                    (rec_g[:, t] - g_lp).abs())
        score = (score + w_lp) + g_lp
        own_w.append(w_lp * alive)
        own_g.append(g_lp)
        alive = alive * (wd != eos_word).float()
    got = served["scores"].reshape(s_).float()
    score_gap = (got - score).abs() / score.abs().clamp_min(1.0)
    per_job = lambda x: x.reshape(n_jobs, kk).amax(1)  # noqa: E731
    by_job = got.reshape(n_jobs, kk)
    rise = ((by_job[:, 1:] - by_job[:, :-1]).clamp_min(0)
            / by_job[:, :-1].abs().clamp_min(1.0))
    beam_gap = torch.maximum(
        torch.maximum(per_job(sel_gap), per_job(rec_gap)),
        torch.maximum(per_job(score_gap),
                      rise.amax(1) if kk > 1 else torch.zeros_like(
                          by_job[:, 0])))
    by_path = lambda x: x.reshape(n_jobs, kk, *x.shape[1:])  # noqa: E731
    n = served["prefix_routes"].shape[1]
    paths = {"words": served["words"], "gates": served["gates"],
             "word_logps": by_path(torch.stack(own_w, 1)),
             "gate_logps": by_path(torch.stack(own_g, 1)),
             "scores": score.reshape(n_jobs, kk),
             "head": by_path(torch.stack(own_head, 1)),
             "head_ids": by_path(torch.stack(own_ids, 1)),
             "routes": by_path(taken[:, n:]),
             "prefix_routes": taken[::kk, :n]}
    return {"route": per_job(route_gap), "logit": per_job(logit_gap),
            "beam": beam_gap, "paths": paths}


@torch.no_grad()
def judge_cut(w, cfg, dets, recons, verb_lists, tense_ids, steps, t,
              chosen=None):
    """How far the beams that step t kept lie below the K best children of
    the beams it chose from (the joint top-K cut), per job.

    Inputs as `judge_beams`'; steps: the program's beams as parent
    pointers, `parents`, `step_words`, `step_gates` (P, T, K) (step s's
    kept beam j extends beam parents[s, j] with that word and gate), and
    optionally `step_routes` (P, T, K, L_moe, 6) (step s's routes of the
    beams live at s) with `prefix_routes` (P, N, L_moe, 6). t >= 1.

    The K beams live at step t are rebuilt from the pointers and run
    through `forward`, along their expert choices where `steps` has them;
    each beam's score is the sum of its children's joint log-probs here
    (`served_child`), and its children at step t are scored as
    `beam_search` scores them. chosen: the kept beams to judge, (parents,
    words, gates) (P, K); the program's at step t by default.

    Returns (gap (P,): the K-th best child's score less the lowest kept
    beam's, in nats, 0 where every kept beam is among the K best, inf
    where one is kept twice; this model's own K best (parents, words,
    gates) (P, K))."""
    par, st_w, st_g = (steps[k].long() for k in
                       ("parents", "step_words", "step_gates"))
    n_jobs, _, kk = par.shape
    s_ = n_jobs * kk
    dev = dets.device
    pj = torch.arange(n_jobs, device=dev)[:, None]
    item = torch.arange(s_, device=dev) // kk
    routes = steps.get("step_routes")
    cur = torch.arange(kk, device=dev).expand(n_jobs, kk)
    words = torch.zeros((n_jobs, kk, t + 1), dtype=torch.long, device=dev)
    gates = torch.zeros_like(words)
    taken = [] if routes is None else [routes[:, t][pj, cur]]
    for s in range(t - 1, -1, -1):
        words[:, :, s] = st_w[:, s].gather(1, cur)
        gates[:, :, s] = st_g[:, s].gather(1, cur)
        cur = par[:, s].gather(1, cur)
        if routes is not None:
            taken.append(routes[:, s][pj, cur])
    words, gates = words.reshape(s_, t + 1), gates.reshape(s_, t + 1)
    forced = prefix_routes = None
    if routes is not None:
        forced = torch.stack(taken[::-1], 2).reshape(
            s_, t + 1, *routes.shape[3:])
        prefix_routes = steps["prefix_routes"]
    h, ptr, _, _ = forward(w, cfg, dets, words, gates,
                           control_tokens(w, recons), item, forced,
                           prefix_routes)
    score = torch.zeros((s_,), device=dev)
    for s in range(t):
        logits, glp = heads(w, h[:, s])
        w_lp, g_lp = served_child(torch.log_softmax(logits, -1), glp,
                                  verb_lists[item, ptr[:, s]], tense_ids,
                                  words[:, s], gates[:, s])
        score = (score + w_lp) + g_lp
    logits, glp = heads(w, h[:, t])
    verb = verb_lists[item, ptr[:, t]]
    w_row, g_row = child_rows(logits, glp, verb, tense_ids)
    vocab = logits.shape[1]
    total = ((score[:, None, None] + w_row[:, :, None])
             + g_row[:, None, :]).reshape(n_jobs, -1)
    top = total.topk(kk, 1)
    own = (top.indices // (2 * vocab), (top.indices % (2 * vocab)) // 2,
           top.indices % 2)
    if chosen is None:
        chosen = (par[:, t], st_w[:, t], st_g[:, t])
    cb, cw, cg = (c.long() for c in chosen)
    rows = (pj * kk + cb).reshape(-1)
    w_lp, g_lp = served_child(torch.log_softmax(logits[rows], -1),
                              glp[rows], verb[rows], tense_ids,
                              cw.reshape(-1), cg.reshape(-1))
    kept = ((score[rows] + w_lp) + g_lp).reshape(n_jobs, kk)
    gap = (top.values[:, -1:] - kept).clamp_min(0).amax(1)
    flat = (cb * vocab + cw) * 2 + cg
    twice = (flat.sort(1).values.diff(1) == 0).any(1)
    return torch.where(twice, math.inf, gap), own


@torch.no_grad()
def beam_search(w, cfg, dets, recons, verb_lists, tense_ids, k):
    """The joint (word x gate) beam search with verb substitution, of this
    model. Inputs as `judge_beams`'. At t = 0 only beam 0 is live; at
    every step the K best of a job's K x V x 2 children (score + word
    logprob + gate logprob) survive, the lowest flat index (beam, word,
    gate) first among equal scores; a verb row's word logprobs are 0 at the
    verb's best tense here (word 0 for a verb without tenses) and VERB_SEA
    elsewhere, its gate logprobs (GATE_CHANGE, 0). Beams are never frozen
    (the eval path gives the gate no EOS).

    Returns (words, gates (P, K, T), scores (P, K) best first, margin
    (P,)): the least gap, in nats, over the steps between the K-th and the
    (K+1)-th best child of a job. Where it is small the two may trade
    places under the program's rounding, and from there on another sound
    search keeps other beams."""
    n_jobs, t_len = dets.shape[0], cfg["seq_len"]
    vocab, dev = cfg["vocab_size"], dets.device
    s_ = n_jobs * k
    item = torch.arange(s_, device=dev) // k
    ctrl_tok = control_tokens(w, recons)
    tok, real, pos = prefix_of(w, dets)
    n = tok.shape[1]
    _, _, past, _ = layers(w, cfg, tok, pos, causal(real, 0), keep=True)
    past = [(kv[0][item], kv[1][item]) for kv in past]
    n_real = real.sum(1)[item]
    seq = torch.zeros((n_jobs, k), device=dev)
    words = torch.zeros((n_jobs, k, t_len), dtype=torch.long, device=dev)
    gates = torch.zeros_like(words)
    margin = torch.full((n_jobs,), math.inf, device=dev)
    for t in range(t_len):
        wd = words.reshape(s_, t_len)[:, :t + 1]
        gt_ = gates.reshape(s_, t_len)[:, :t + 1]
        x, ptr = caption_inputs(w, cfg, wd, gt_, ctrl_tok, item)
        p_cap = n_real[:, None] + torch.arange(t + 1, device=dev)
        ok = causal(real[item], t + 1)[:, n:]
        h, _, _, _ = layers(w, cfg, x, p_cap, ok, past)
        logits, glp = heads(w, h[:, -1])
        w_row, g_row = child_rows(logits, glp, verb_lists[item, ptr[:, -1]],
                                  tense_ids)
        total = ((seq[:, :, None, None] + w_row.reshape(n_jobs, k, vocab, 1))
                 + g_row.reshape(n_jobs, k, 1, 2))
        if t == 0:
            total[:, 1:] = -math.inf
        vals, idx = torch.sort(total.reshape(n_jobs, -1), dim=1,
                               descending=True, stable=True)
        kth, nxt = vals[:, k - 1], vals[:, k]
        margin = torch.minimum(margin, kth - nxt)
        seq, idx = vals[:, :k], idx[:, :k]
        beam = idx // (2 * vocab)
        hist = beam[:, :, None].expand(-1, -1, t_len)
        words = words.gather(1, hist)
        gates = gates.gather(1, hist)
        words[:, :, t] = (idx % (2 * vocab)) // 2
        gates[:, :, t] = idx % 2
    return words, gates, seq, margin
