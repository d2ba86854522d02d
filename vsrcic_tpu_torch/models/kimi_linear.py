"""Kimi-Linear-48B-A3B's language model as a caption decoder of the port.

The decoder of moonshotai/Kimi-Linear-48B-A3B-Instruct (its `config.json`,
arXiv 2510.26692): 27 pre-norm layers at hidden 2304, three of every four
mixing tokens with Kimi Delta Attention (KDA), the fourth with latent
attention (MLA) without positions (`mla_use_nope`); layer 0's MLP dense
(SwiGLU 9216), layers 1-26 routing each token to 8 of 256 SwiGLU experts
of 1024 beside one shared expert; a final RMSNorm and an untied head over
163840 ids. Everything but KDA is Kimi-VL's block at other numbers
(`models/kimi_vl.py`: the MLA functions with `rot` None, `route`, `moe`,
the prefill and decode layer loops through their `mix` seam, the facade).

  * KDA, per layer, head h (32 of D = 128) and token: q~, k~, v~ =
    SiLU(causal depthwise conv4(W x)) over 4096 channels each (one stacked
    product, `in_proj`, with W_fa, W_ga and W_b); q = q~ / |q~| D^-1/2,
    k = k~ / |k~| (per head, eps 1e-6 under the root); g = -exp(A_log_h)
    softplus(W_fb W_fa x + dt_bias), alpha = exp(g); beta = sigmoid(W_b
    x); S <- (I - beta k k^T) Diag(alpha) S + beta k v^T; o = S^T q; y =
    W_o [RMSNorm_h(o) w sigmoid(W_gb W_ga x)]. No product has a bias. The
    recurrence is `ops/kda.py::kda_recurrence` (its kernel on the card).
  * Expert parallelism's share: the deployment splits each layer's 256
    experts over four cards; this one holds `experts_held` of them from
    `first_expert` on, routes over all 256 and computes its own experts'
    part (`kimi_vl.moe`); the shared expert, both attention kinds, the
    embedding and the head are whole here.
  * State: each beam row holds a KDA state of 32 x 128 x 128 f32 a KDA
    layer (held once: `KdaState`; a row reads its parent's state and
    writes its own in place, inside the recurrence's kernel, so a beam
    reorder moves parent pointers only) and the last 3 pre-conv inputs of
    each conv (bf16, read by parent, written in place); each MLA layer's
    latents in Kimi-VL's `LatentCache` (copied at each reorder).
  * Precision: bf16 weights and activations, products accumulated in f32;
    the KDA state, the conv outputs, the decay, beta, the L2 norms and
    every RMSNorm statistic in f32; the router, softmax and log-probs in
    f32. Any float dtype runs (the CPU tests take f32).

The captioning wiring is Kimi-VL's: projected detections as the prefix
(real ones only: the facade moves them ahead of the padding, so the
convolutions and the recurrence see only real tokens and padding neither
decays nor updates a state), the control token, the gate head, the "tma"
word head. The prefix's KDA state and conv window are made once a job, in
its first beam's row, and read by all its beams at step 0.

`KimiLinearCaptioner` is the facade (`KimiVLCaptioner` with the layer
kinds and the caches as seams). Spans: Kimi-VL's, and `vlm.kda` around
each KDA layer (prefill, decode step or its CUDA graph's replay, and the
state's reorder), with counts `kda_state_bytes` (state the recurrence
read and wrote), `conv_moved_bytes` (conv windows gathered by parent) and
`state_moved_bytes` (state and conv windows a reorder copied: 0); the
device count `kda_parents` (`device_counts`: the parent states the decode
read, each distinct parent of a step once).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vsrcic_tpu_torch.models import kimi_vl as kv
from vsrcic_tpu_torch.models.kimi_vl import (KimiVLCaptioner, KimiVLConfig,
                                             LatentCache, decode_layers,
                                             mla_decode, mla_prefill, nest,
                                             prefill, rms_norm)
from vsrcic_tpu_torch.ops.kda import (conv_qkv, gated_norm,
                                     kda_recurrence)
from vsrcic_tpu_torch.utils import observability as obs

F32 = 4


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig(KimiVLConfig):
    """The published config.json (defaults; `from_published` reads one)
    and the captioning wiring's sizes. `n_routed_experts` is the router's
    width (256), `experts_held` the experts this chip holds from
    `first_expert` on; `kda_layers` numbers the KDA layers from 0."""
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_attention_heads: int = 32
    n_shared_experts: int = 1
    n_routed_experts: int = 256
    num_experts_per_tok: int = 8
    experts_held: int = 64
    kda_layers: tuple = (0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 16, 17, 18,
                         20, 21, 22, 24, 25)
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4

    @property
    def kda_width(self):
        return self.kda_heads * self.kda_head_dim

    @property
    def mla_layers(self):
        return tuple(i for i in range(self.num_hidden_layers)
                     if i not in self.kda_layers)

    @classmethod
    def from_published(cls, d, **wiring):
        """From the published config.json's keys (`num_experts` the experts
        held here, `num_experts_published` the router's width when they
        differ) and the wiring's (`det_feat_size`, `seq_len`, `bos_idx`)."""
        lin = d["linear_attn_config"]
        return cls(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            moe_intermediate_size=d["moe_intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            n_shared_experts=d["num_shared_experts"],
            n_routed_experts=d.get("num_experts_published", d["num_experts"]),
            experts_held=d["num_experts"],
            num_experts_per_tok=d["num_experts_per_token"],
            routed_scaling_factor=d["routed_scaling_factor"],
            kv_lora_rank=d["kv_lora_rank"],
            qk_nope_head_dim=d["qk_nope_head_dim"],
            qk_rope_head_dim=d["qk_rope_head_dim"],
            v_head_dim=d["v_head_dim"],
            first_k_dense_replace=d["first_k_dense_replace"],
            norm_topk_prob=d["moe_renormalize"],
            rms_norm_eps=d["rms_norm_eps"],
            kda_layers=tuple(i - 1 for i in lin["kda_layers"]),
            kda_heads=lin["num_heads"], kda_head_dim=lin["head_dim"],
            conv_size=lin["short_conv_kernel_size"], **wiring)


def param_shapes(cfg: KimiLinearConfig):
    """{dotted name: shape} of every parameter: Kimi-VL's, with each KDA
    layer's mixer in place of MLA's (`in_proj` stacks W_q, W_k, W_v,
    W_fa, W_ga and W_b by rows; `conv` the depthwise conv4 of q, k and v)
    and the held experts only."""
    h, hd, d = cfg.hidden_size, cfg.kda_width, cfg.kda_head_dim
    shapes = kv.param_shapes(dataclasses.replace(
        cfg, n_routed_experts=cfg.experts_held))
    for i in range(cfg.num_hidden_layers):
        pre = "layers.%d." % i
        if "%srouter" % pre in shapes:
            shapes[pre + "router"] = (cfg.n_routed_experts, h)
            shapes[pre + "router_bias"] = (cfg.n_routed_experts,)
        if i not in cfg.kda_layers:
            continue
        for k in ("q_proj", "kv_a", "kv_norm", "kv_b", "o_proj"):
            del shapes[pre + k]
        shapes.update({pre + k: s for k, s in (
            ("in_proj", (3 * hd + 2 * d + cfg.kda_heads, h)),
            ("conv", (3 * hd, cfg.conv_size)), ("f_b", (hd, d)),
            ("g_b", (hd, d)), ("A_log", (cfg.kda_heads,)),
            ("dt_bias", (hd,)), ("o_norm", (d,)), ("o_proj", (h, hd)))})
    return shapes


NORMS = ("attn_norm", "kv_norm", "mlp_norm", "norm", "o_norm")
F32_LEAVES = ("router_bias", "A_log", "dt_bias")


def draw_leaf(leaf, shape, gen, std=0.02, bias_std=1e-3,
              dt_range=(5e-4, 5e-2), a_range=(1.0, 2.0)):
    """One parameter, drawn on `gen`'s device in f32: norms 1, biases 0,
    the router's correction bias normal (0, bias_std), the conv weights
    uniform (-1/2, 1/2) (PyTorch's Conv1d default at fan-in 4), A_log =
    log A with A uniform in `a_range` a head, dt_bias the inverse softplus
    of dt log-uniform in `dt_range` a channel (so that at W_fb W_fa x = 0
    the decay alpha = exp(-A dt) lies in [0.905, 0.9995]), matrices normal
    (0, std)."""
    dev = gen.device
    if leaf in NORMS:
        return torch.ones(shape, device=dev)
    if leaf == "bias":
        return torch.zeros(shape, device=dev)
    if leaf == "router_bias":
        return torch.randn(shape, generator=gen, device=dev) * bias_std
    u = torch.rand(shape, generator=gen, device=dev)
    if leaf == "conv":
        return u - 0.5
    if leaf == "A_log":
        return torch.log(a_range[0] + (a_range[1] - a_range[0]) * u)
    if leaf == "dt_bias":
        lo, hi = torch.log(torch.tensor(dt_range, device=dev))
        dt = torch.exp(lo + (hi - lo) * u)
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=gen, device=dev) * std


def init_kimi_linear_params(gen, cfg: KimiLinearConfig,
                            dtype=torch.bfloat16, device="cpu", **draw):
    """Random weights (`draw_leaf`), stored in `dtype` on `device`; the
    router's correction bias, A_log and dt_bias in f32."""
    flat = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        val = draw_leaf(leaf, shape, gen, **draw)
        flat[name] = val.to(device=device, dtype=torch.float32
                            if leaf in F32_LEAVES else dtype)
    return nest(flat, cfg.num_hidden_layers)


# ---------------------------------------------------------------------------
# the KDA layer
# ---------------------------------------------------------------------------

def kda_project(lp, cfg, x):
    """The layer's products of the normed tokens x (..., H) and its decay
    rates, what `ops/kda.py::conv_qkv` and `gated_norm` take: in_proj's
    rows (..., 3 x 4096 + 2D + heads: the pre-conv q, k, v, W_fa x, W_ga
    x, beta's pre-sigmoid) in x's dtype; the heads' decay rates A =
    exp(A_log) (heads,) f32 (g = -A softplus(f + dt_bias)); f = W_fb W_fa
    x (..., 4096) and the output gate's pre-sigmoid (..., 4096) in x's
    dtype."""
    d, c = cfg.kda_head_dim, 3 * cfg.kda_width
    proj = F.linear(x, lp["in_proj"])
    f = F.linear(proj[..., c:c + d], lp["f_b"])
    gate = F.linear(proj[..., c + d:c + 2 * d], lp["g_b"])
    return proj, torch.exp(lp["A_log"].float()), f, gate


def conv_step(pre, conv, parent, w):
    """One decode position of the layer's input stage (`conv_qkv` at T =
    1): the rows' products pre = (in_proj's rows (R, ...), the decay
    rates, f), after their parents' last K - 1 pre-conv inputs (conv (R,
    K - 1, C), read at `parent` (R,) int32, each row's own window written
    in place); w = (the layer's parameters, the beam: a job's rows, one
    group). Returns q, k, v, g (R, 1, heads, D) and beta (R, 1, heads),
    f32."""
    (proj, rate, f), (lp, beam) = pre, w
    return conv_qkv(proj[:, None], f[:, None], rate, lp["dt_bias"],
                    lp["conv"], conv, parent=parent, group=beam)


def kda_out(lp, cfg, o, gate):
    """The recurrence's o (..., heads, D) f32 through the gated RMSNorm
    (f32; `ops/kda.py::gated_norm`) and the output projection, in the
    gate's dtype."""
    return F.linear(gated_norm(o, gate, lp["o_norm"], cfg.rms_norm_eps),
                    lp["o_proj"])


def kda_prefill(lp, cfg, h, real, state, conv, rows_in, rows_out):
    """A KDA layer over prefixes whose real tokens lead: h (P, N, H) normed,
    real (P, N). The recurrence starts from rows_in's states (-1: zeros)
    and leaves each job's in `state[rows_out]` (R, heads, D, D); its last
    K - 1 real pre-conv inputs go into `conv[rows_out]` (R, K - 1, C).
    Returns the mixer's output (P, N, H), 0 at padding."""
    proj, rate, f, gate = kda_project(lp, cfg, h)
    q, k, v, g, beta = conv_qkv(proj, f, rate, lp["dt_bias"], lp["conv"],
                                conv, lengths=real.sum(1, dtype=torch.int32),
                                rows_out=rows_out)
    o = kda_recurrence(q, k, v, g, beta, state, rows_in, rows_out,
                       real.to(torch.uint8), group=1)
    return kda_out(lp, cfg, o, gate)


def kda_decode(lp, cfg, x, state, conv, parent, rows, beam, probe=None):
    """A KDA layer at one decode position: x (R, H) normed; row r reads its
    parent's state and conv window (`parent` (R,) int32 rows of `state`
    (R, heads, D, D) and `conv` (R, K - 1, C)) and writes its own in place
    (state at `rows`, (R,) int32, and conv at r), the beam's K rows of a
    job one group. `probe` (see `KimiLinearCaptioner.probe`): the
    recurrence's inputs and output at its job's rows, copied there.
    Returns the output (R, H)."""
    proj, rate, f, gate = kda_project(lp, cfg, x)
    q, k, v, g, beta = conv_step((proj, rate, f), conv, parent, (lp, beam))
    if probe is not None:
        at = probe.rows
        probe.parent.copy_(parent[at])
        probe.state.copy_(state[at])
    o = kda_recurrence(q, k, v, g, beta, state, parent, rows, None,
                       group=beam)
    if probe is not None:
        for name, val in (("q", q), ("k", k), ("v", v), ("g", g),
                          ("beta", beta), ("o", o)):
            getattr(probe, name).copy_(val[at, 0])
    return kda_out(lp, cfg, o[:, 0], gate)


# ---------------------------------------------------------------------------
# the beams' state
# ---------------------------------------------------------------------------

class KdaState:
    """The beams' KDA states and conv windows, held once: `state` (L_kda,
    R, heads, D, D) f32, `conv` (L_kda, R, K - 1, C); `parent` (R,) int64,
    the row whose state each row starts its next step from. Indexing by
    rows (the beam's `_gather_beam`) copies nothing: it takes the parent
    pointers."""

    def __init__(self, state, conv, parent):
        self.state, self.conv, self.parent = state, conv, parent

    def __getitem__(self, rows):
        return KdaState(self.state, self.conv, self.parent[rows])


def moved_bytes(old: KdaState, new: KdaState):
    """The bytes of `new`'s states and conv windows that lie in storage
    other than `old`'s: what a reorder from old to new copied."""
    return sum(b.nbytes for a, b in ((old.state, new.state),
                                     (old.conv, new.conv))
               if b.untyped_storage().data_ptr()
               != a.untyped_storage().data_ptr())


class HybridCache:
    """The two kinds of state side by side: the MLA layers' latents and
    the KDA layers' states; indexing by rows reorders both, the KDA
    states' reorder inside `vlm.kda` with the bytes it copied
    (`state_moved_bytes`, `moved_bytes`)."""

    def __init__(self, latent: LatentCache, kda: KdaState):
        self.latent, self.kda = latent, kda

    @property
    def filled(self):
        return self.latent.filled

    def __getitem__(self, rows):
        latent = self.latent[rows]
        with obs.span("vlm.kda"):
            kda = self.kda[rows]
            obs.count("state_moved_bytes", moved_bytes(self.kda, kda))
        return HybridCache(latent, kda)


HybridBeamResult = NamedTuple("HybridBeamResult", [
    (f, torch.Tensor) for f in kv.VLMBeamResult._fields] + [
        ("probe", object)])
HybridBeamResult.__doc__ = """`VLMBeamResult`'s fields and `probe`: None, or
{name: tensor} of the probed KDA layer's recurrence at the probed step and
job (`KimiLinearCaptioner.probe`): `rows` (K,) the job's rows, `parent`
(K,) the rows each row read, `state` (K, heads, D, D) the job's rows'
states before the step, `q`, `k`, `v`, `g` (K, heads, D), `beta` (K,
heads), `o` (K, heads, D)."""


class KimiLinearCaptioner(KimiVLCaptioner):
    """The facade `EvalPipeline` drives in place of `ControllableCaptioner`:
    `KimiVLCaptioner` with KDA layers beside the MLA ones.

    probe: None, or (KDA layer index from 0, step, job): that layer's
    recurrence at that step copies its inputs and output at the rows of
    the job (modulo a batch's jobs) into the result
    (`HybridBeamResult.probe`), for a check of the recurrence as the timed
    path ran it. Set it before the first batch: the copies are part of
    the layer's CUDA graph."""

    probe = None

    def __init__(self, cfg: KimiLinearConfig, params, verb_2_vob_all=None,
                 device=None):
        super().__init__(cfg, params, verb_2_vob_all, device)
        self.parents_total = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        self.kinds = ["kda" if i in cfg.kda_layers else "mla"
                      for i in range(cfg.num_hidden_layers)]
        # each layer's index among the layers of its kind
        self.slot = [self.kinds[:i].count(kind)
                     for i, kind in enumerate(self.kinds)]

    def _new_buffers(self, n_jobs, n, k):
        cfg, dev = self.cfg, self.device
        rows = n_jobs * k
        buf = super()._new_buffers(n_jobs, n, k, len(cfg.mla_layers),
                                   (kda_recurrence, conv_qkv, gated_norm))
        nh, d, lk = cfg.kda_heads, cfg.kda_head_dim, len(cfg.kda_layers)
        i32 = torch.int32
        buf.kda_state = torch.empty((lk, rows, nh, d, d), device=dev)
        buf.kda_conv = torch.empty((lk, rows, cfg.conv_size - 1,
                                    3 * cfg.kda_width),
                                   dtype=self.params["embed"].dtype,
                                   device=dev)
        buf.parent = torch.empty((rows,), dtype=i32, device=dev)
        buf.rows = torch.arange(rows, dtype=i32, device=dev)
        buf.pre_in = torch.full((n_jobs,), -1, dtype=i32, device=dev)
        buf.pre_out = buf.rows[::k].contiguous()
        buf.probe = None
        if self.probe is not None:
            job = self.probe[2] % n_jobs
            vec = (k, nh, d)
            buf.probe = SimpleNamespace(
                rows=torch.arange(job * k, job * k + k, device=dev),
                parent=torch.empty((k,), dtype=i32, device=dev),
                state=torch.empty((k, nh, d, d), device=dev),
                q=torch.empty(vec, device=dev), k=torch.empty(vec, device=dev),
                v=torch.empty(vec, device=dev), g=torch.empty(vec, device=dev),
                beta=torch.empty((k, nh), device=dev),
                o=torch.empty(vec, device=dev))
        return buf

    def device_counts(self):
        """Kimi-VL's device counts and `kda_parents`: the states a KDA
        layer's decode calls read since the facade was made, each step's
        distinct parent rows (one a job at step 0, the prefill's)."""
        return dict(super().device_counts(),
                    kda_parents=int(self.parents_total))

    def _state_bytes(self, rows):
        """The KDA states of `rows` rows in one layer, in bytes."""
        return rows * self.cfg.kda_heads * self.cfg.kda_head_dim ** 2 * F32

    def _prefill(self, buf, detections):
        """Kimi-VL's prefill through the hybrid's mixers, on the jobs'
        detections with the real ones moved ahead of the padding (in
        order); the prefix's routes put back in the detections' order."""
        cfg, p = self.cfg, self.params
        real = detections.sum(-1) != 0
        order = torch.argsort((~real).to(torch.uint8), dim=1, stable=True)
        dets = detections.gather(1, order[..., None].expand_as(detections))
        lats = buf.prefix[0]

        def mix(i, lp):
            j = self.slot[i]
            if self.kinds[i] == "kda":
                def attend(h, real, mask):
                    return kda_prefill(lp, cfg, h, real, buf.kda_state[j],
                                       buf.kda_conv[j], buf.pre_in,
                                       buf.pre_out)
                return "vlm.kda", attend, {
                    "kda_state_bytes": self._state_bytes(dets.shape[0])}

            def attend(h, real, mask):
                a, lat = mla_prefill(lp, cfg, h, None, mask)
                lats[j] = lat.masked_fill(~real[..., None], 0.0)
                return a
            return "vlm.attn", attend, {}
        prefix = prefill(p, cfg, dets, buf.pre_counts, buf.prefix, mix)
        r = prefix.routes
        return prefix._replace(routes=torch.empty_like(r).scatter_(
            1, order[:, :, None, None].expand_as(r), r))

    def _first_cache(self, buf, n_jobs, k):
        rows = torch.arange(n_jobs * k, device=self.device)
        return HybridCache(LatentCache(*buf.caches),
                           KdaState(buf.kda_state, buf.kda_conv,
                                    rows // k * k))

    def _decode(self, buf, statics, cache, t, k, job):
        cfg, x = self.cfg, buf.x
        prefix = statics.prefix
        buf.parent.copy_(cache.kda.parent)
        rows = x.shape[0]
        moved = rows * (cfg.conv_size - 1) * buf.kda_conv.shape[-1] * (
            buf.kda_conv.element_size())
        layer, step, _ = self.probe or (None, None, None)

        def mix(i, lp):
            j = self.slot[i]
            if self.kinds[i] == "kda":
                probe = buf.probe if (j, t) == (layer, step) else None

                def fn():
                    x.add_(kda_decode(lp, cfg, rms_norm(
                        x, lp["attn_norm"], cfg.rms_norm_eps),
                        buf.kda_state[j], buf.kda_conv[j], buf.parent,
                        buf.rows, k, probe))
                return "vlm.kda", fn, {
                    "kda_state_bytes": 2 * self._state_bytes(rows),
                    "conv_moved_bytes": moved}

            def fn():
                x.add_(mla_decode(lp, cfg, rms_norm(
                    x, lp["attn_norm"], cfg.rms_norm_eps), None,
                    prefix.latents[j], prefix.bias,
                    cache.latent.writer(j, t), k))
            return "vlm.attn", fn, {}
        return decode_layers(self.params, cfg, x, None, statics, cache, t, k,
                             buf.dec_counts[t], buf.routes, buf.graphs.run,
                             mix)

    def _advance(self, cache, t):
        kda = cache.kda
        rows = torch.arange(kda.parent.shape[0], device=self.device)
        return HybridCache(super()._advance(cache.latent, t),
                           KdaState(kda.state, kda.conv, rows))

    @torch.no_grad()
    def _beam_v_impl(self, detections, det_groups, verb_list, beam_size,
                     eos_word, gt):
        res = super()._beam_v_impl(detections, det_groups, verb_list,
                                   beam_size, eos_word, gt)
        buf = self._shapes[(detections.shape[0], detections.shape[1],
                            beam_size)]
        # step t's rows read the parents selection t - 1 kept
        kept = res.parents[:, :-1].sort(-1).values
        self.parents_total += kept.shape[0] + kept[..., :1].numel() + (
            kept[..., 1:] != kept[..., :-1]).sum()
        probe = None
        if buf.probe is not None:
            probe = {n: getattr(buf.probe, n).clone() for n in (
                "rows", "parent", "state", "q", "k", "v", "g", "beta", "o")}
        return HybridBeamResult(*res, probe)
