"""Kimi-VL-A3B's language model as a caption decoder of the port.

The decoder of moonshotai/Kimi-VL-A3B-Instruct (its `config.json`'s
`text_config`, the DeepSeek-V3 block of the HF modelling code): an
embedding, 27 pre-norm layers (RMSNorm -> latent attention (MLA) ->
residual -> RMSNorm -> MLP or mixture of experts -> residual), a final
RMSNorm and an untied head over 163840 ids. Layer 0 is a dense SwiGLU MLP
of width 11264; layers 1-26 route each token to 6 of 64 SwiGLU experts of
width 1408 and add 2 shared experts (one SwiGLU MLP of width 2816).

  * MLA: q = W_q x (16 heads x (128 nope + 64 rope)); [c_kv; k_pe] =
    W_kva x (512 + 64), c_kv RMS-normed; [k_nope; v] = W_kvb c_kv (16 x
    (128 + 128)). RoPE (theta 800000, no scaling) on q_pe and the shared
    k_pe, read as HF's DeepSeek-V3 code reads them: each head's 64 dims
    are 32 interleaved pairs, pair j turned by pos x theta^(-2j/64).
    Softmax scale 192^-0.5. The prefill takes the expanded
    form (per-head keys and values, causal over the prefix); a decode step
    the absorbed form: W_UK folded into q (q_lat = q_nope W_UK, 512 wide),
    W_UV into the output, attention over the cached latents (c_kv, k_pe),
    576 values a position a layer.
  * MoE (`noaux_tc`, n_group 1): s = sigmoid(W_r x) in f32, the top 6 of
    s + b_corr chosen, each weighted s_i / sum of the chosen s x 2.446.
    y = sum_i w_i E_i(x) + S(x). The routed tokens are sorted by expert
    and the experts run as two grouped products (`torch._grouped_mm`);
    no token is dropped. Padded prefix tokens are sorted after every
    expert's group and are not computed.
  * Precision: bf16 weights and activations, products accumulated in f32
    (cuBLAS, CUTLASS); RMSNorm statistics, RoPE's angles, the router,
    softmax, the weighted sum of the experts' outputs and the log-probs in
    f32. Any float dtype runs (the CPU tests take f32).

Departures from the HF modelling code: RMSNorm rounds once, after its
weight (`F.rms_norm`; HF rounds the normed value, then scales it); RoPE
turns each pair in f32 and rounds once (HF rounds cos and sin first), and
leaves the pairs interleaved where HF de-interleaves them: q_pe and k_pe
alike, so every score is HF's; the absorbed decode rounds q_lat and the
attention's latent output to bf16 where the expanded form rounds k_nope
and v; an MLP's gate and up projections are one stacked matrix ([gate;
up], rows), the same products.

The captioning wiring is the system's own (configuration `assumed`):

  * a job's detections (N, 2048) go through a projector (2048 -> 2048,
    GELU, 2048 -> 2048) to give its prefix tokens; detections that are
    all zero are padding, masked from attention; the real ones take
    positions 0 .. N_real - 1 in order;
  * the prefix is prefilled once per job (`prefill`); the job's beams
    share its latent cache by job index, never copied;
  * step t's input is Embed(w_{t-1}) (BOS at t = 0) plus the control
    token: the masked mean of the projected regions of the current group,
    whose pointer advances by the previous gate (`_feedback_inputs`); its
    position is N_real + t;
  * a gate head (Linear 2048 -> 2, log-softmax) reads the final normed
    hidden; the word head is the head table through
    `ops/vocab_topk.vocab_topk_lse` (bf16 hidden and table: the "tma"
    route), top k = beam, and verb slots take the verb's best tense on the
    head table (`_verb_target`), as the role-shift captioner's do.

`KimiVLCaptioner` is the facade: `beam_search_v` has
`ControllableCaptioner.beam_search_v`'s signature, so `EvalPipeline`
drives it unchanged. Its result also holds every step's beams as parent
pointers (which beam each kept beam extends, with which word and gate, and
the routes of the beams the step chose from), from which the final paths'
records are read by ancestry (`ancestry`) and a check can rebuild the
beams live at any step. Spans (`utils/observability.py`): `vlm.prefill`,
`vlm.attn`, `vlm.moe` (with `vlm.route` inside it where the layer runs
as it is: off the card, and on a decode shape's first batch, whose layers
are then captured as CUDA graphs and replayed inside `vlm.attn` and
`vlm.moe`, `DecodeGraphs`), `vlm.cache` (each reorder of the beams'
latent caches) and `vlm.head`. Counts: on
`vlm.prefill` `prefill_rows` (padded), and, read back from the device
without waiting (a batch or more late), `prefix_tokens`, `expert_pairs`
(routed token-expert pairs) and `expert_max` (the largest per-expert count
of each MoE call, summed); on `vlm.cache` `cache_bytes` (latents written)
and `cache_moved_bytes` (latents the reorders copy).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vsrcic_tpu_torch.decode.beam import beam_search_joint_candidates
from vsrcic_tpu_torch.decode.graphs import (CudaGraph, add_counts,
                                            counts_added, launch_counts)
from vsrcic_tpu_torch.models.api import build_verb_tense_table
from vsrcic_tpu_torch.models.captioner import (_feedback_inputs, _verb_curr,
                                               _verb_target,
                                               topk_candidates)
from vsrcic_tpu_torch.ops.vocab_topk import padded_table, vocab_topk_lse
from vsrcic_tpu_torch.utils import observability as obs
from vsrcic_tpu_torch.utils.device import as_tensor, resolve_device, to_device

# device counts a batch: routed pairs, the largest expert count of each
# call summed, experts with at least one token summed; each phase
COUNTS = ("prefix_tokens", "prefill_pairs", "prefill_expert_max",
          "prefill_experts_hit", "decode_pairs", "decode_expert_max",
          "decode_experts_hit")


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """The published text_config (defaults) and the captioning wiring's
    sizes (`det_feat_size`, `seq_len`, `bos_idx`)."""
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    det_feat_size: int = 2048
    seq_len: int = 20
    bos_idx: int = 2
    # the first routed expert this chip holds (`moe`: the experts' stacked
    # weights say how many)
    first_expert: int = 0

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self):
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def moe_layers(self):
        return self.num_hidden_layers - self.first_k_dense_replace

    @classmethod
    def from_dict(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def param_shapes(cfg: KimiVLConfig):
    """{dotted name: shape} of every parameter (`layers.<i>.` per layer).
    Linear weights are (out, in); experts stacked (E, out, in)."""
    h, v, nh = cfg.hidden_size, cfg.vocab_size, cfg.num_attention_heads
    shapes = {"embed": (v, h), "proj.fc1.weight": (h, cfg.det_feat_size),
              "proj.fc1.bias": (h,), "proj.fc2.weight": (h, h),
              "proj.fc2.bias": (h,), "norm": (h,), "lm_head": (v, h),
              "gate_head.weight": (2, h), "gate_head.bias": (2,)}
    for i in range(cfg.num_hidden_layers):
        s = {"attn_norm": (h,),
             "q_proj": (nh * cfg.qk_head_dim, h),
             "kv_a": (cfg.latent_dim, h),
             "kv_norm": (cfg.kv_lora_rank,),
             "kv_b": (nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                      cfg.kv_lora_rank),
             "o_proj": (h, nh * cfg.v_head_dim),
             "mlp_norm": (h,)}
        if i < cfg.first_k_dense_replace:
            s.update(gate_up=(2 * cfg.intermediate_size, h),
                     down=(h, cfg.intermediate_size))
        else:
            e, w = cfg.n_routed_experts, cfg.moe_intermediate_size
            sw = w * cfg.n_shared_experts
            s.update(router=(e, h), router_bias=(e,),
                     experts_gate_up=(e, 2 * w, h), experts_down=(e, h, w),
                     shared_gate_up=(2 * sw, h), shared_down=(h, sw))
        shapes.update({"layers.%d.%s" % (i, k): v for k, v in s.items()})
    return shapes


def nest(flat, n_layers):
    """{dotted name: tensor} -> the params tree: `layers` a list of dicts."""
    tree = {"layers": [{} for _ in range(n_layers)]}
    for name, val in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = val
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = val
    return tree


def init_kimi_vl_params(gen: torch.Generator, cfg: KimiVLConfig,
                        dtype=torch.bfloat16, device="cpu", std=0.02,
                        bias_std=1e-3):
    """Random weights: normal (0, `std`) matrices (HF's initializer_range),
    unit norms, zero biases, the router's correction bias normal (0,
    `bias_std`) in f32 (the learned one is not in the repository). Drawn
    on `gen`'s device, stored in `dtype` on `device`."""
    flat = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_norm", "kv_norm", "mlp_norm", "norm"):
            val = torch.ones(shape)
        elif leaf == "bias":
            val = torch.zeros(shape)
        elif leaf == "router_bias":
            val = torch.randn(shape, generator=gen, device=gen.device
                              ).cpu() * bias_std
            flat[name] = val.to(device=device, dtype=torch.float32)
            continue
        else:
            val = torch.randn(shape, generator=gen, device=gen.device) * std
        flat[name] = val.to(device=device, dtype=dtype)
    return nest(flat, cfg.num_hidden_layers)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps):
    """RMSNorm (`F.rms_norm`: statistics in f32, one rounding to x's
    dtype after the weight; HF rounds before it)."""
    return F.rms_norm(x, weight.shape, weight, eps)


def rope_angles(pos, cfg: KimiVLConfig):
    """e^(i pos theta_j) (*pos.shape, rope dim / 2), complex64."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, device=pos.device,
                                                 dtype=torch.float32) / d))
    f = pos.float()[..., None] * inv
    return torch.polar(torch.ones_like(f), f)


def apply_rope(x, rot):
    """Pair j of x (..., d), (x_2j, x_2j+1), turned by rot's angle j, in
    f32, rounded to x's dtype. The pairs stay interleaved where HF's
    output de-interleaves them (evens, then odds): q_pe and k_pe are laid
    out alike either way, so every score is HF's."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * rot).flatten(-2).to(x.dtype)


def swiglu(x, gate_up, down):
    g, u = F.linear(x, gate_up).chunk(2, -1)
    return F.linear(F.silu(g) * u, down)


def projector(p, feats):
    """Detections (..., D) -> tokens (..., H) in the weights' dtype."""
    w = p["proj"]
    x = feats.to(w["fc1"]["weight"].dtype)
    x = F.gelu(F.linear(x, w["fc1"]["weight"], w["fc1"]["bias"]))
    return F.linear(x, w["fc2"]["weight"], w["fc2"]["bias"])


def _mla_qkv(lp, cfg, x, rot):
    """q_nope (..., H, 128), the roped q_pe (..., H, 64), the normed c_kv
    (..., 512) and the roped k_pe (..., 64); rot None: NoPE, q_pe and k_pe
    as projected (nothing is turned)."""
    dn = cfg.qk_nope_head_dim
    q = F.linear(x, lp["q_proj"]).unflatten(-1, (cfg.num_attention_heads,
                                                 cfg.qk_head_dim))
    kva = F.linear(x, lp["kv_a"])
    c_kv = rms_norm(kva[..., :cfg.kv_lora_rank], lp["kv_norm"],
                    cfg.rms_norm_eps)
    q_pe, k_pe = q[..., dn:], kva[..., cfg.kv_lora_rank:]
    if rot is not None:
        q_pe, k_pe = apply_rope(q_pe, rot[..., None, :]), apply_rope(k_pe,
                                                                     rot)
    return q[..., :dn], q_pe, c_kv, k_pe


def mla_prefill(lp, cfg, x, rot, mask):
    """Expanded-form attention over a padded prefix. x (P, N, H); rot
    (P, N, 32), or None (NoPE); mask (P, 1, N, N) bool, True where a query
    may attend. Returns (output (P, N, H), latents (P, N, 576))."""
    nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.v_head_dim)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(lp, cfg, x, rot)
    kv = F.linear(c_kv, lp["kv_b"]).unflatten(-1, (nh, dn + dv))
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([kv[..., :dn],
                   k_pe[..., None, :].expand(*k_pe.shape[:-1], nh, -1)], -1)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), kv[..., dn:].transpose(1, 2),
        attn_mask=mask, scale=cfg.qk_head_dim ** -0.5)
    o = o.transpose(1, 2).flatten(-2)
    return F.linear(o, lp["o_proj"]), torch.cat([c_kv, k_pe], -1)


def absorbed(lp, cfg):
    """W_UK (H, 128, 512) and W_UV^T (H, 512, 128): views of W_kvb."""
    nh, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
    w = lp["kv_b"].unflatten(0, (nh, dn + cfg.v_head_dim))
    return w[:, :dn], w[:, dn:].transpose(1, 2)


def mla_decode(lp, cfg, x, rot, prefix, bias, own, beam):
    """Absorbed-form attention of one decode step. x (R, H) with R = P x
    beam rows; rot (R, 32), or None (NoPE); prefix (P, N, 576) the jobs'
    cached latents; bias (P, 1, >= N + S) f32: 0, or -inf at the prefix's
    padding; own: a callable that stores this step's (c_kv, k_pe) and
    returns the rows' cached latents, this step's included, as an (R, S,
    576) view. Returns
    the output (R, H)."""
    nh, dv = cfg.num_attention_heads, cfg.v_head_dim
    r, c = x.shape[0], cfg.kv_lora_rank
    p_jobs, n = prefix.shape[:2]
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(lp, cfg, x, rot)
    lat = own(c_kv, k_pe)                                     # (R, S, 576)
    w_uk, w_uv_t = absorbed(lp, cfg)
    q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk)           # (H, R, 512)
    qc = torch.cat([q_lat.transpose(0, 1), q_pe], -1)         # (R, H, 576)
    width = n + lat.shape[1]
    s = torch.cat([torch.bmm(qc.reshape(p_jobs, beam * nh, -1),
                             prefix.transpose(1, 2)).reshape(r, nh, n),
                   torch.bmm(qc, lat.transpose(1, 2))], -1)
    s = s.reshape(p_jobs, beam * nh, width).float()
    prob = torch.softmax(s.mul_(cfg.qk_head_dim ** -0.5).add_(
        bias[..., :width]), -1).to(x.dtype).reshape(r, nh, width)
    o_lat = torch.baddbmm(
        torch.bmm(prob[..., n:], lat[..., :c]).reshape(p_jobs, beam * nh, c),
        prob[..., :n].reshape(p_jobs, beam * nh, n), prefix[..., :c])
    o = torch.bmm(o_lat.reshape(r, nh, c).transpose(0, 1), w_uv_t)
    return F.linear(o.transpose(0, 1).reshape(r, nh * dv), lp["o_proj"])


def route(lp, cfg, x):
    """The router: (weights (T, k) f32, expert ids (T, k) int64)."""
    s = torch.sigmoid(F.linear(x.float(), lp["router"].float()))
    _, idx = torch.topk(s + lp["router_bias"], cfg.num_experts_per_tok,
                        dim=-1)
    w = s.gather(1, idx)
    scale = cfg.routed_scaling_factor
    if cfg.norm_topk_prob:
        return w * (scale / (w.sum(-1, keepdim=True) + 1e-20)), idx
    return w * scale, idx


def moe(lp, cfg, x, valid=None, counts=None):
    """Routed experts plus the shared ones over tokens x (T, H). The router
    spans all `cfg.n_routed_experts`; this chip holds the E experts whose
    weights `lp` stacks, from `cfg.first_expert` on (expert parallelism's
    share: all of them for Kimi-VL). `valid` (T,) bool: tokens that are
    not padding. Pairs of padding and pairs routed to an expert not held
    are sorted after the last held expert's group, not computed, and add
    0: what the absent experts would give is another chip's part of the
    layer. `counts`: an (E,) slot that receives each held expert's
    cumulative end in the sorted pairs. Returns (y (T, H), expert ids (T,
    k), numbered over all the router's experts)."""
    e, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    held = lp["experts_gate_up"].shape[0]
    keep = None
    with obs.span("vlm.route"):
        w, idx = route(lp, cfg, x)
        key = idx.reshape(-1)
        if held < e:
            key = key - cfg.first_expert
            keep = (key >= 0) & (key < held)
            if valid is not None:
                keep &= valid[:, None].expand(-1, k).reshape(-1)
            key = torch.where(keep, key, held)
        elif valid is not None:
            key = torch.where(valid[:, None].expand(-1, k).reshape(-1), key,
                              e)
        skey, order = torch.sort(key, stable=True)
        # each expert's end in the sorted pairs (torch.bincount would read
        # the largest key back to the host)
        ends = torch.searchsorted(skey, torch.arange(held, device=x.device),
                                  right=True)
        if counts is not None:
            counts.copy_(ends)
        a = x[order // k]
    offs = ends.to(torch.int32)
    g, u = torch._grouped_mm(a, lp["experts_gate_up"].transpose(-2, -1),
                             offs=offs).chunk(2, -1)
    out = torch._grouped_mm(F.silu(g) * u,
                            lp["experts_down"].transpose(-2, -1), offs=offs)
    routed = torch.empty_like(out).index_copy_(0, order, out)
    routed = routed.unflatten(0, (-1, k))
    if keep is not None:
        routed = torch.where(keep.view(-1, k, 1), routed, 0.0)
    elif valid is not None:
        routed = torch.where(valid[:, None, None], routed, 0.0)
    y = torch.bmm(w[:, None, :], routed.float())[:, 0].to(x.dtype)
    return y + swiglu(x, lp["shared_gate_up"], lp["shared_down"]), idx


def mlp(lp, cfg, x, valid=None, counts=None):
    """A layer's MLP over tokens (T, H): (y, expert ids (T, k) or None)."""
    if "router" in lp:
        return moe(lp, cfg, x, valid, counts)
    return swiglu(x, lp["gate_up"], lp["down"]), None


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

class Prefix(NamedTuple):
    """A batch's prefilled prefixes, shared by each job's beams."""
    latents: torch.Tensor       # (L, P, N, 576) per layer, padding zero
    bias: torch.Tensor          # (P, 1, N + seq_len) f32: 0, or -inf at
                                # the prefix's padding
    n_real: torch.Tensor        # (P,) int64: the real detections
    routes: torch.Tensor        # (P, N, L_moe, k) uint8: experts chosen


def prefill(p, cfg: KimiVLConfig, dets, counts=None, out=None, mix=None):
    """The jobs' detections (P, N, D) through the projector and every
    layer, causal over the real ones in order. `counts`: (L_moe, E) slots
    of `moe`'s; `out`: (latents, bias) buffers to fill (else new ones).

    `mix(i, lp)`, the layer kinds' seam: layer i's token mixer, as (span,
    attend, counts): attend(h, real, mask) takes the normed tokens (P, N,
    H), real (P, N) and the causal mask of the real tokens, keeps what the
    decode reads and returns the mixer's output; the counts are counted
    inside the span. Default: MLA with RoPE at the real tokens' positions
    on every layer, each layer's latents into `latents`.
    Returns a `Prefix`."""
    n_jobs, n = dets.shape[:2]
    real = dets.sum(-1) != 0                                   # (P, N)
    x = torch.where(real[..., None], projector(p, dets), 0.0)
    ar = torch.arange(n, device=dets.device)
    mask = ((ar[:, None] >= ar[None, :])
            & (real[:, None, :] | (ar[:, None] == ar[None, :])))[:, None]
    lats, bias = out if out is not None else (
        torch.empty((cfg.num_hidden_layers, n_jobs, n, cfg.latent_dim),
                    dtype=x.dtype, device=x.device),
        torch.empty((n_jobs, 1, n + cfg.seq_len), device=x.device))
    if mix is None:
        rot = rope_angles((real.cumsum(1) - 1).clamp_min(0), cfg)

        def mix(i, lp):
            def attend(h, real, mask):
                a, lat = mla_prefill(lp, cfg, h, rot, mask)
                lats[i] = lat.masked_fill(~real[..., None], 0.0)
                return a
            return "vlm.attn", attend, {}
    routes = []
    flat_real = real.reshape(-1)
    for i, lp in enumerate(p["layers"]):
        span, attend, counted = mix(i, lp)
        with obs.span(span):
            for name, n_ in counted.items():
                obs.count(name, n_)
            x = x + attend(rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps),
                           real, mask)
        with obs.span("vlm.moe"):
            h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
            slot = (None if counts is None or "router" not in lp
                    else counts[len(routes)])
            m, idx = mlp(lp, cfg, h.reshape(-1, h.shape[-1]), flat_real,
                         slot)
            x = x + m.reshape(x.shape)
        if idx is not None:
            routes.append(idx.to(torch.uint8).reshape(n_jobs, n, -1))
    bias[:, 0, :n] = torch.where(real, 0.0, -torch.inf)
    bias[:, 0, n:] = 0.0
    return Prefix(lats, bias, real.sum(1), torch.stack(routes, 2))


class LatentCache:
    """The beams' own latents: `buf` (T, R, L, 576) position-major, its
    first `filled` positions written. Indexing by rows (the beam's
    `_gather_beam`) copies just those positions of the selected rows into
    the spare buffer, which becomes the new cache's, inside `vlm.cache`."""

    def __init__(self, buf, spare, filled=0):
        self.buf, self.spare, self.filled = buf, spare, filled

    def __getitem__(self, rows):
        n = self.filled
        with obs.span("vlm.cache"):
            torch.index_select(self.buf[:n], 1, rows, out=self.spare[:n])
            obs.count("cache_moved_bytes",
                      n * rows.shape[0] * self.buf[0, 0].nbytes)
        return LatentCache(self.spare, self.buf, n)

    def writer(self, layer, t):
        """`mla_decode`'s `own` for `layer` at position t."""
        def own(c_kv, k_pe):
            c = c_kv.shape[-1]
            self.buf[t, :, layer, :c] = c_kv
            self.buf[t, :, layer, c:] = k_pe
            return self.buf[:t + 1, :, layer].transpose(0, 1)
        return own


class VLMStatics(NamedTuple):
    """A decode's per-job inputs (`_feedback_inputs` reads det_groups'
    group count)."""
    det_groups: torch.Tensor    # (P, L, H): each group's control token
    verb_list: torch.Tensor     # (P, L) verb ids or -1
    prefix: Prefix


class VLMState(NamedTuple):
    """The beam's state, rows = P x beam; every field follows every
    selection (`_gather_beam`)."""
    ctrl_det_idx: torch.Tensor  # (R,) int64: current region-group pointer
    cache: LatentCache
    parent: torch.Tensor        # (R,) int64: each row's index before the
                                # last selection (its parent's row)


class VLMBeamResult(NamedTuple):
    """`BeamResult`'s fields; what the decode computed along each final
    path (by ancestry); the prefill's routes; then every step's beams as
    parent pointers: the beams a selection kept (their parents, words and
    gates) and the routes of the beams it chose from."""
    words: torch.Tensor
    gates: torch.Tensor
    word_logps: torch.Tensor
    gate_logps: torch.Tensor
    scores: torch.Tensor
    routes: torch.Tensor        # (P, K, T, L_moe, k) uint8
    head: torch.Tensor          # (P, K, T, k + 3) f32: top-k logits, lse,
                                # gate log-probs (before verb substitution)
    head_ids: torch.Tensor      # (P, K, T, k) int32: the top-k logits' ids
    prefix_routes: torch.Tensor  # (P, N, L_moe, k) uint8
    n_real: torch.Tensor        # (P,) int64
    parents: torch.Tensor       # (P, T, K) int64: the beam (0..K-1) that
                                # step t's kept beam j extends
    step_words: torch.Tensor    # (P, T, K) int64: the word it took
    step_gates: torch.Tensor    # (P, T, K) int64: and its gate
    step_routes: torch.Tensor   # (P, T, K, L_moe, k) uint8: step t's
                                # routes of the beams it chose from


def ancestry(rec, parents):
    """Per-step records along each final path: rec (T, R, ...) by the rows
    live at each step, parents (T, R) the row each row kept at step t came
    from -> (R, T, ...)."""
    rows = torch.arange(parents.shape[1], device=parents.device)
    out = []
    for t in reversed(range(parents.shape[0])):
        rows = parents[t, rows]
        out.append(rec[t, rows])
    return torch.stack(out[::-1], 1)


def decode_layers(p, cfg, x, rot, statics, cache, t, beam, counts=None,
                  routes=None, run=None, mix=None):
    """One decode step through every layer, in place on x (R, H); rot
    (R, 32) the rows' RoPE turns. Each layer's attention and MLP are one
    call each of `run(key, fn)` (`DecodeGraphs.run`: fn once, or its CUDA
    graph), inside the spans `vlm.attn` and `vlm.moe`; `routes` (R, L_moe,
    k) receives the experts chosen. `mix(i, lp)`, the layer kinds' seam:
    (span, fn, counts), fn adding layer i's mixer to x in place, run under
    that span, the counts counted there (outside any graph); default: MLA
    over the prefix's and `cache`'s latents of layer i. Returns the final
    normed hidden."""
    prefix = statics.prefix
    run = run or (lambda key, fn: fn())
    moe_i = 0
    for i, lp in enumerate(p["layers"]):
        def attn(lp=lp, i=i):
            x.add_(mla_decode(lp, cfg, rms_norm(x, lp["attn_norm"],
                                                cfg.rms_norm_eps),
                              rot, prefix.latents[i], prefix.bias,
                              cache.writer(i, t), beam))
        span, counted = "vlm.attn", {}
        if mix is not None:
            span, attn, counted = mix(i, lp)

        def ffn(lp=lp, j=moe_i):
            slot = None if counts is None or "router" not in lp else counts[j]
            m, idx = mlp(lp, cfg, rms_norm(x, lp["mlp_norm"],
                                           cfg.rms_norm_eps), counts=slot)
            x.add_(m)
            if idx is not None and routes is not None:
                routes[:, j] = idx
        with obs.span(span):
            for name, n_ in counted.items():
                obs.count(name, n_)
            run(("attn", t, i), attn)
        with obs.span("vlm.moe"):
            run(("moe", t, i), ffn)
        moe_i += "router" in lp
    return rms_norm(x, p["norm"], cfg.rms_norm_eps)


class DecodeGraphs:
    """CUDA graphs of a decode shape's layers: `run(key, fn)` runs fn as it
    is on a shape's first batch (and always off the card); from its second
    on, it captures fn once per key (layer, part and step) on a side
    stream into one shared memory pool, and replays it. fn reads and writes
    only the shape's persistent buffers (`KimiVLCaptioner._buffers`), so a
    replay redoes the captured work on the batch at hand. A replay's
    kernels stand under the span around it, as fn's would. A replay skips
    the Python wrappers of the kernels, so it adds what its capture added
    to their launch counters (`counted`: every attribute of each object
    whose name starts with "launches", as `decode/graphs.py::StepGraphs`
    does). graph: a callable that makes an object with `capture(fn)` and
    `replay()` (tests pass a stand-in), by default CUDA graphs on the
    card and none elsewhere."""

    def __init__(self, device, counted=(), graph=None):
        self.graphs = {}
        self.live = False
        self.counted = tuple(counted)
        self._graph = (graph if graph is not None or device.type != "cuda"
                       else self._cuda)
        self._pool = self._stream = None

    def run(self, key, fn):
        if not (self.live and self._graph is not None):
            return fn()
        entry = self.graphs.get(key)
        if entry is None:
            before = launch_counts(self.counted)
            g = self._graph()
            g.capture(fn)
            entry = self.graphs[key] = (g, counts_added(
                before, launch_counts(self.counted)))
        else:
            add_counts(self.counted, entry[1])
        entry[0].replay()

    def _cuda(self):
        """A CUDA graph on the side stream and shared pool, made (with the
        libraries' handles) before the first capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
            self._warm()
        return CudaGraph(self._stream, self._pool)

    def _warm(self):
        """Make the side stream's library handles and workspaces before the
        first capture: one small product of each kind the layers take."""
        a = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            F.linear(a, a)
            F.linear(a.float(), a.float())
            torch.bmm(a[None], a[None])
            torch.baddbmm(a[None], a[None], a[None])
            torch._grouped_mm(a, a[None].expand(2, -1, -1).contiguous()
                              .transpose(-2, -1),
                              offs=torch.tensor([8, 16], dtype=torch.int32,
                                                device="cuda"))
        torch.cuda.current_stream().wait_stream(self._stream)


def control_tokens(p, groups):
    """Each group's control token: the mean of its projected regions that
    are not all zero (0 for an empty group). groups (P, L, M, D) ->
    (P, L, H), the weights' dtype."""
    mask = (groups.sum(-1) != 0).float()
    tok = projector(p, groups).float()
    s = (tok * mask[..., None]).sum(2)
    return (s / mask.sum(2, keepdim=True).clamp_min(1.0)).to(p["embed"].dtype)


class KimiVLCaptioner:
    """The facade `EvalPipeline` drives in place of `ControllableCaptioner`.

    params: the tree of `init_kimi_vl_params` (or the benchmark's), kept by
    reference, never written. The word head is `vocab_topk_lse` (its
    kernel on the card, its plain version on the CPU). device: "cuda"
    unless given."""

    def __init__(self, cfg: KimiVLConfig, params, verb_2_vob_all=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = to_device(
            {k: v for k, v in params.items() if k != "layers"}, self.device)
        self.params["layers"] = [to_device(lp, self.device)
                                 for lp in params["layers"]]
        dtype = self.params["embed"].dtype
        # the recons arrive in the decoder's dtype (EvalPipeline)
        self.table_dtype = dtype
        self.tense_table = (build_verb_tense_table(verb_2_vob_all,
                                                   device=self.device)
                            if verb_2_vob_all is not None else None)
        head = self.params["lm_head"]
        self._head = {"weight": head,
                      "bias": torch.zeros(head.shape[0], device=self.device)}
        self._w_t = padded_table(head.T)
        self.counts_total = torch.zeros(len(COUNTS), dtype=torch.int64,
                                        device=self.device)
        # the routed experts each MoE layer holds here
        self.held = self.params["layers"][-1]["experts_gate_up"].shape[0]
        self._pending = None
        self._seen = {}
        self._shapes = {}

    def _harvest(self):
        """Count, in the open span, the device counts that have come back
        since the last call (`COUNTS`), then start copying the totals back
        again (pinned memory behind an event: nothing waits)."""
        if self._pending is not None:
            host, ready = self._pending
            if ready is not None and not ready.query():
                return
            now = dict(zip(COUNTS, host.tolist()))
            d = {k: now[k] - self._seen.get(k, 0) for k in COUNTS}
            obs.count("prefix_tokens", d["prefix_tokens"])
            obs.count("expert_pairs", d["prefill_pairs"] + d["decode_pairs"])
            obs.count("expert_max", d["prefill_expert_max"]
                      + d["decode_expert_max"])
            self._seen = now
        if self.device.type == "cuda":
            host = torch.empty(len(COUNTS), dtype=torch.int64,
                               pin_memory=True)
            host.copy_(self.counts_total, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = self.counts_total.clone(), None
        self._pending = (host, ready)

    def device_counts(self):
        """{name: total} of `COUNTS` since the facade was made (reads the
        device: waits for it)."""
        return dict(zip(COUNTS, self.counts_total.tolist()))

    def _count(self, prefill_ends, decode_ends, n_real):
        """Add a batch's per-call expert counts (from each call's experts'
        ends in its sorted pairs) to the device totals."""
        e = self.held
        parts = [n_real.sum()]
        for ends in (prefill_ends, decode_ends):
            c = torch.diff(ends.reshape(-1, e), dim=1, prepend=torch.zeros(
                (ends.numel() // e, 1), dtype=ends.dtype, device=ends.device))
            parts += [c.sum(), c.amax(1).sum(), (c > 0).sum()]
        self.counts_total += torch.stack(parts)

    def _vocab_fn(self, k):
        return lambda h: vocab_topk_lse(h.contiguous(), self._w_t,
                                        self._head["bias"], k=k)

    def _buffers(self, n_jobs, n, k):
        """A decode shape's persistent buffers and its graphs
        (`_new_buffers`), made at its first batch."""
        key = (n_jobs, n, k)
        if key not in self._shapes:
            self._shapes[key] = self._new_buffers(n_jobs, n, k)
        buf = self._shapes[key]
        buf.graphs.live = buf.batches > 0
        buf.batches += 1
        return buf

    def _new_buffers(self, n_jobs, n, k, latent_layers=None, counted=()):
        """The rows' hidden state and RoPE turns, the beams' two latent
        caches of `latent_layers` layers (default: every layer; the
        reorders alternate between them), the prefix's latents and mask,
        the experts' counts and choices, the graphs (replays advancing the
        launch counters of `counted`)."""
        cfg, dev = self.cfg, self.device
        dtype = self.params["embed"].dtype
        rows, t_len, lm = n_jobs * k, cfg.seq_len, cfg.moe_layers
        layers = latent_layers or cfg.num_hidden_layers
        lat = (t_len, rows, layers, cfg.latent_dim)
        e = self.held
        return SimpleNamespace(
            x=torch.empty((rows, cfg.hidden_size), dtype=dtype, device=dev),
            rot=torch.empty((rows, cfg.qk_rope_head_dim // 2),
                            dtype=torch.complex64, device=dev),
            caches=(torch.empty(lat, dtype=dtype, device=dev),
                    torch.empty(lat, dtype=dtype, device=dev)),
            prefix=(torch.empty((layers, n_jobs, n, cfg.latent_dim),
                                dtype=dtype, device=dev),
                    torch.empty((n_jobs, 1, n + t_len), device=dev)),
            pre_counts=torch.zeros((lm, e), dtype=torch.long, device=dev),
            dec_counts=torch.zeros((t_len, lm, e), dtype=torch.long,
                                   device=dev),
            routes=torch.zeros((rows, lm, cfg.num_experts_per_tok),
                               dtype=torch.long, device=dev),
            graphs=DecodeGraphs(dev, counted), batches=0)

    # the seams a decoder of other layer kinds overrides (models/
    # kimi_linear.py): the prefill, the beams' first cache, one step
    # through the layers, and the cache after a step

    def _prefill(self, buf, detections):
        return prefill(self.params, self.cfg, detections, buf.pre_counts,
                       buf.prefix)

    def _first_cache(self, buf, n_jobs, k):
        return LatentCache(*buf.caches)

    def _decode(self, buf, statics, cache, t, k, job):
        buf.rot.copy_(rope_angles(statics.prefix.n_real[job] + t, self.cfg))
        return decode_layers(self.params, self.cfg, buf.x, buf.rot, statics,
                             cache, t, k, buf.dec_counts[t], buf.routes,
                             buf.graphs.run)

    def _advance(self, cache, t):
        with obs.span("vlm.cache"):
            obs.count("cache_bytes", cache.buf[t].nbytes)
        return LatentCache(cache.buf, cache.spare, t + 1)

    @torch.no_grad()
    def _beam_v_impl(self, detections, det_groups, verb_list, beam_size,
                     eos_word, gt):
        cfg, p, dev = self.cfg, self.params, self.device
        k = beam_size
        n_jobs = detections.shape[0]
        rows = n_jobs * k
        t_len = cfg.seq_len
        buf = self._buffers(n_jobs, detections.shape[1], k)
        with obs.span("vlm.prefill"):
            self._harvest()
            obs.count("prefill_rows", detections.shape[0]
                      * detections.shape[1])
            prefix = self._prefill(buf, detections)
            statics = VLMStatics(control_tokens(p, det_groups), verb_list,
                                 prefix)
        with obs.span("vlm.cache"):
            obs.count("cache_bytes", prefix.latents.nbytes)
        lm, ke = cfg.moe_layers, cfg.num_experts_per_tok
        rec = SimpleNamespace(
            parents=torch.zeros((t_len, rows), dtype=torch.long, device=dev),
            words=torch.zeros((t_len, rows), dtype=torch.long, device=dev),
            gates=torch.zeros((t_len, rows), dtype=torch.long, device=dev),
            routes=torch.zeros((t_len, rows, lm, ke), dtype=torch.uint8,
                               device=dev),
            head=torch.zeros((t_len, rows, k + 3), device=dev),
            head_ids=torch.zeros((t_len, rows, k), dtype=torch.int32,
                                 device=dev))
        row_ids = torch.arange(rows, device=dev)
        state = VLMState(torch.zeros((rows,), dtype=torch.long, device=dev),
                         self._first_cache(buf, n_jobs, k), row_ids)
        job = row_ids // k
        vocab_fn = self._vocab_fn(k)

        def step_fn(state, pw, pg, t0):
            cache = state.cache
            t = cache.filled
            if t:
                rec.parents[t - 1] = state.parent
                rec.words[t - 1] = pw
                rec.gates[t - 1] = pg
            it, ctrl = _feedback_inputs(cfg, state, statics, pw, pg, t0)
            buf.x.copy_(p["embed"][it] + statics.det_groups[job, ctrl])
            h = self._decode(buf, statics, cache, t, k, job)
            cache = self._advance(cache, t)
            with obs.span("vlm.head"):
                vals, ids, lse = vocab_fn(h)
                g = self.params["gate_head"]
                glp = torch.log_softmax(torch.addmm(
                    g["bias"].float(), h.float(), g["weight"].float().T), -1)
                verb_curr = _verb_curr(statics.verb_list[job], ctrl)
                tgt = _verb_target(self._head, h.float(), verb_curr,
                                   self.tense_table, gt, cfg.vocab_size)
                cand = topk_candidates(vals, ids, lse, glp, verb_curr, tgt, k)
            rec.routes[t] = buf.routes
            rec.head[t] = torch.cat([vals, lse, glp], 1)
            rec.head_ids[t] = ids
            return cand, VLMState(ctrl, cache, row_ids)

        res, state = beam_search_joint_candidates(
            step_fn, state, n_jobs, k, t_len, eos_word=eos_word,
            vocab_size=cfg.vocab_size, with_state=True)
        rec.parents[-1] = state.parent
        rec.words[-1] = res.words[:, :, -1].reshape(-1)
        rec.gates[-1] = res.gates[:, :, -1].reshape(-1)
        self._count(buf.pre_counts, buf.dec_counts, prefix.n_real)
        view = lambda x: x.reshape(n_jobs, k, *x.shape[1:])  # noqa: E731
        # (T, R, ...) -> (P, T, K, ...)
        steps = lambda x: x.reshape(t_len, n_jobs, k, *x.shape[2:]  # noqa: E731
                                    ).transpose(0, 1)
        return VLMBeamResult(
            *res, *(view(ancestry(r, rec.parents)) for r in
                    (rec.routes, rec.head, rec.head_ids)),
            prefix.routes, prefix.n_real, steps(rec.parents % k),
            steps(rec.words), steps(rec.gates), steps(rec.routes))

    def beam_search_v(self, detections, det_groups, verb_list, eos_word,
                      beam_size=5, gt=False) -> VLMBeamResult:
        """Beam decode with verb substitution, as
        `ControllableCaptioner.beam_search_v`: detections (B, N, D),
        det_groups (B, L, M, D), verb_list (B, L) verb ids or -1."""
        dev = self.device
        return self._beam_v_impl(
            as_tensor(detections, dev), as_tensor(det_groups, dev),
            as_tensor(verb_list, dev, torch.long), beam_size=beam_size,
            eos_word=eos_word, gt=gt)
