"""Kimi-Linear-48B-A3B's language model as a caption decoder, in plain PyTorch.

The plain reference of `vsrcic_tpu_torch/models/kimi_linear.py`: float32
math (the caller turns TF32 off), no kernel, cache or batching trick,
written from the published equations (moonshotai/Kimi-Linear-48B-A3B-
Instruct's `config.json`, arXiv 2510.26692) and the captioning wiring the
configuration states. It imports nothing but torch and its sibling
`kimi_vl_lm.py`, whose helpers it runs unchanged over this model's layers.

The block (`layers`): RMSNorm -> token mixer -> residual -> RMSNorm -> MLP
or experts -> residual, the mixer by layer kind:

  * KDA (`kda`), the recurrence run position by position in the form the
    equation states, over each path's real tokens only (padding neither
    decays nor updates the state, nor enters a conv window):
      q~, k~, v~ = SiLU(causal depthwise conv4(W_q x)), likewise W_k, W_v;
      q = q~ / |q~| D^-1/2, k = k~ / |k~| (per head, eps 1e-6 under the
      root); g = -exp(A_log) softplus(W_fb W_fa x + dt_bias); alpha =
      exp(g); beta = sigmoid(W_b x);
      S_t = (I - beta k k^T) Diag(alpha) S_{t-1} + beta k v^T, S_0 = 0;
      o = S_t^T q; y = W_o [RMSNorm(o) w sigmoid(W_gb W_ga x)] per head;
  * MLA without positions: Kimi-VL's expanded form (`kimi_vl_lm.attention`)
    at angle 0, which turns nothing (its de-interleave permutes q_pe's and
    k_pe's dimensions alike, so every score is the unrotated one);
  * experts: the router over all `n_routed_experts`, the top k of s +
    b_corr, weights normalised over the k chosen and scaled; only the
    experts whose weights the layer holds (from `first_expert` on) add
    their part, as on the chip that holds them (the absent experts' part
    is another chip's); the shared expert once.

With cfg["kda_state"] "bfloat16" (the control) the KDA state is rounded to
bf16 after every update; with cfg["expert_inputs"] "float8_e4m3fn" every
expert product takes float8 inputs (`kimi_vl_lm.float8`).

`forward`, `judge_beams`, `judge_cut` and `beam_search` are
`kimi_vl_lm`'s, run over this module's `layers` (a layer's "past" is its
KDA state and conv window, or MLA's keys and values). `judge_recurrence`
holds one KDA layer's step, as the program computed it, to the equation
from the same inputs.
"""
from __future__ import annotations

import torch

from . import kimi_vl_lm as vl

L2_EPS = 1e-6
F = torch.nn.functional


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda_step(s, q, k, v, alpha, beta, bf16=False):
    """One token on states s (..., D, Dv): S' = (I - beta k k^T) Diag(alpha)
    S + beta k v^T, o = S'^T q. q, k, alpha (..., D); v (..., Dv); beta
    (...). `bf16`: S' rounded to bf16 (the control). Returns (S', o)."""
    b = beta[..., None, None]
    s = alpha[..., None] * s
    s = s - b * k[..., :, None] * (k[..., None, :] @ s)
    s = s + b * k[..., :, None] * v[..., None, :]
    if bf16:
        s = s.to(torch.bfloat16).float()
    return s, (q[..., None, :] @ s)[..., 0, :]


def kda(lp, cfg, x, real, past=None):
    """KDA over normed tokens x (S, T, H); real (S, T) bool; past: (state
    (S, heads, D, D), window (S, K - 1, 3 x heads x D)) after earlier
    tokens, or None. Returns (output (S, T, H), (state, window) after
    the last real token)."""
    nh, d, kk = cfg["kda_heads"], cfg["kda_head_dim"], cfg["conv_size"]
    hd = nh * d
    w = lp["in_proj"]
    pre = x @ w[:3 * hd].T                                     # q, k, v
    f = (x @ w[3 * hd:3 * hd + d].T) @ lp["f_b"].T
    g = -torch.exp(lp["A_log"])[:, None] * F.softplus(
        f.unflatten(-1, (nh, d)) + lp["dt_bias"].view(nh, d))
    beta = torch.sigmoid(x @ w[3 * hd + 2 * d:].T)
    gate = torch.sigmoid((x @ w[3 * hd + d:3 * hd + 2 * d].T) @ lp["g_b"].T)
    s_, t_len = x.shape[:2]
    if past is None:
        state = torch.zeros((s_, nh, d, d), device=x.device)
        window = torch.zeros((s_, kk - 1, 3 * hd), device=x.device)
    else:
        state, window = past
    bf16 = cfg.get("kda_state") == "bfloat16"
    outs = []
    for t in range(t_len):
        live = real[:, t]
        full = torch.cat([window, pre[:, t, None]], 1)         # (S, K, C)
        y = F.silu((full * lp["conv"].T).sum(1))
        q, k, v = (y[:, i * hd:(i + 1) * hd].unflatten(-1, (nh, d))
                   for i in range(3))
        s_new, o = kda_step(state, l2norm(q) * d ** -0.5, l2norm(k), v,
                            torch.exp(g[:, t]), beta[:, t], bf16)
        state = torch.where(live[:, None, None, None], s_new, state)
        window = torch.where(live[:, None, None], full[:, 1:], window)
        outs.append(torch.where(live[:, None, None], o, 0.0))
    o = vl.rms_norm(torch.stack(outs, 1), lp["o_norm"], cfg["rms_norm_eps"])
    o = o * gate.unflatten(-1, (nh, d))
    return o.flatten(-2) @ lp["o_proj"].T, (state, window)


def mla(lp, cfg, x, pos, ok, past=None):
    """MLA without positions (see the module's note): Kimi-VL's expanded
    form at angle 0."""
    return vl.attention(lp, cfg, x, torch.zeros_like(pos), ok, past)


def moe(lp, cfg, x, forced=None):
    """Routed and shared experts over tokens x (T, H), this chip's part:
    `kimi_vl_lm.moe` with the router over all `n_routed_experts` and only
    the held experts (`lp`'s stacked weights, from cfg["first_expert"]
    on) computed. forced (T, k): the experts to take. Returns (y, gap
    (T,), the experts taken (T, k))."""
    k = cfg["num_experts_per_tok"]
    first, held = cfg.get("first_expert", 0), lp["experts_gate_up"].shape[0]
    s = torch.sigmoid(x @ lp["router"].T)
    choice = s + lp["router_bias"]
    top = choice.topk(k, -1)
    idx = top.indices if forced is None else forced.long()
    gap = (top.values[:, -1:] - choice.gather(1, idx)).clamp_min(0).amax(1)
    wt = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * cfg["routed_scaling_factor"]
    q = vl.float8 if cfg.get("expert_inputs") == "float8_e4m3fn" else (
        lambda t: t)

    def expert(t, gate_up, down):
        g, u = (q(t) @ q(gate_up).T).chunk(2, -1)
        return q(F.silu(g) * u) @ q(down).T

    y = expert(x, lp["shared_gate_up"], lp["shared_down"])
    for e in range(held):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if len(tok):
            out = expert(x[tok], lp["experts_gate_up"][e],
                         lp["experts_down"][e])
            y = y.index_add(0, tok, out * wt[tok, slot, None])
    return y, gap, idx


def layers(w, cfg, x, pos, ok, past=None, forced=None, real=None,
           keep=False):
    """`kimi_vl_lm.layers` over this model's layer kinds: every layer over
    tokens x (S, T, H). past: each layer's state after earlier tokens (S
    rows); forced (S, T, L_moe, k); real (S, T) bool: the real tokens
    (their route gaps count; without it, the tokens that are not all
    zero: the prefix's padding is zeroed, `kimi_vl_lm.prefix_of`). Returns
    (the final normed hidden, route gap (S,), each layer's state if
    `keep`, the experts taken (S, T, L_moe, k))."""
    s_, t_ = x.shape[:2]
    live = real if real is not None else x.ne(0).any(-1)
    gap = torch.zeros((s_,), device=x.device)
    kept, taken = [], []
    moe_i = 0
    for i, lp in enumerate(w["layers"]):
        lp = vl.upcast(lp)
        h = vl.rms_norm(x, lp["attn_norm"], cfg["rms_norm_eps"])
        before = None if past is None else past[i]
        if "in_proj" in lp:
            a, state = kda(lp, cfg, h, live, before)
        else:
            a, state = mla(lp, cfg, h, pos, ok, before)
        if keep:
            kept.append(state)
        x = x + a
        h = vl.rms_norm(x, lp["mlp_norm"], cfg["rms_norm_eps"]).reshape(
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
            y = vl.swiglu(h, lp["gate_up"], lp["down"])
        x = x + y.reshape(s_, t_, -1)
        del lp
    return (vl.rms_norm(x, w["norm"].float(), cfg["rms_norm_eps"]), gap, kept,
            torch.stack(taken, 2))


# kimi_vl_lm's forward and judges, unchanged, over this module's `layers`
_NAMES = dict(vars(vl), layers=layers)


def _over_layers(fn):
    inner = getattr(fn, "__wrapped__", fn)
    new = type(inner)(inner.__code__, _NAMES, inner.__name__,
                      inner.__defaults__, inner.__closure__)
    new.__doc__ = inner.__doc__
    return torch.no_grad()(new) if inner is not fn else new


forward = _NAMES["forward"] = _over_layers(vl.forward)
judge_beams = _over_layers(vl.judge_beams)
judge_cut = _over_layers(vl.judge_cut)
beam_search = _over_layers(vl.beam_search)


@torch.no_grad()
def judge_recurrence(probe, cfg, o=None):
    """One KDA layer's step at one job's K rows, held to the equation:
    `probe` holds the step's inputs as the program had them (`rows` (K,)
    the job's rows, `parent` (K,) the rows whose states each starts from,
    `state` (K, heads, D, D) the job's rows' states before the step, `q`,
    `k`, `v`, `g` (K, heads, D), `beta` (K, heads)) and its output `o`.
    Returns (gap, this model's o): gap, over rows and heads, the largest
    |o - o_ref| over max |o_ref|, o the probe's unless given; o_ref from
    `kda_step` in f32, or with the state in bf16 under cfg["kda_state"]."""
    p = {k: v.float() if v.is_floating_point() else v
         for k, v in probe.items()}
    start = p["state"][(p["parent"].long() - p["rows"][0]).clamp(
        0, p["state"].shape[0] - 1)]
    _, mine = kda_step(start, p["q"], p["k"], p["v"], torch.exp(p["g"]),
                       p["beta"], cfg.get("kda_state") == "bfloat16")
    _, want = kda_step(start, p["q"], p["k"], p["v"], torch.exp(p["g"]),
                       p["beta"])
    got = p["o"] if o is None else o
    gap = ((got - want).abs().amax(-1)
           / want.abs().amax(-1).clamp_min(1e-30)).amax()
    return gap, mine
