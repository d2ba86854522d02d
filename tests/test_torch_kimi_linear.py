"""Kimi-Linear-48B-A3B's language model as the port's caption decoder
(`models/kimi_linear.py`) against its plain reference
(`reference_torch/kimi_linear_lm.py`) at a tiny size on the CPU, in
float32: one dense layer, then KDA, KDA, KDA, MLA, KDA, MLA; 16 routed
experts of which 8 are held, top 4, one shared. Prefill and decode through
both kinds of state against the reference's full forward, the joint beam
against the reference's own search, padding among the detections, the
recurrence op with parents, the expert shares against the uncut layer,
Kimi-VL's launches and outputs as before the hybrid's seams, the spans
and counters, and faults that each break a check."""
from __future__ import annotations

import collections
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from reference_torch import kimi_linear_lm as ref
from vsrcic_tpu_torch.models import kimi_linear as kl
from vsrcic_tpu_torch.models import kimi_vl as kv
from vsrcic_tpu_torch.ops import kda as kda_op
from vsrcic_tpu_torch.utils import observability as obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
LIMITS = os.path.join(REPO, "vsrbench", "limits",
                      "vsr-kimilinear.kda-stream-b128.json")
CFG = kl.KimiLinearConfig(
    vocab_size=50, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=6, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=16, experts_held=8,
    num_experts_per_tok=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, kda_layers=(0, 1, 2, 4), kda_heads=4,
    kda_head_dim=16, conv_size=4, det_feat_size=24, seq_len=6)
RCFG = dataclasses.asdict(CFG)
EOS = 3
K = 3
# float32 program against the float32 reference: the same sums in other
# orders (the recurrence's einsums against the equation's products, the
# absorbed MLA decode against the expanded full forward, the convolutions'
# taps), so a few float32 ulps of the logits
TOL = 1e-4
SERVED = ("words", "gates", "word_logps", "gate_logps", "scores", "head",
          "head_ids", "routes", "prefix_routes")


def world(seed=0, cfg=CFG, real=(7, 4, 5)):
    g = torch.Generator().manual_seed(seed)
    p = kl.init_kimi_linear_params(g, cfg, dtype=torch.float32, std=0.2,
                                   bias_std=0.05)
    n_jobs, n, n_groups, m = 3, 7, 4, 5
    dets = torch.randn(n_jobs, n, cfg.det_feat_size, generator=g)
    dets *= (torch.arange(n)[None] < torch.tensor(real)[:, None])[..., None]
    groups = torch.randn(n_jobs, n_groups, m, cfg.det_feat_size, generator=g)
    groups[:, :, 3:] = 0
    groups[1, 2:] = 0
    verbs = torch.full((n_jobs, n_groups), -1)
    verbs[0, 1] = 2
    verbs[2, 0] = 1
    rng = np.random.RandomState(seed)
    tense = {str(v): (4 + rng.choice(cfg.vocab_size - 4, 3,
                                     replace=False)).tolist()
             for v in range(1, 4)}
    return p, dets, groups, verbs, tense


def decode(seed=0, p=None, cfg=CFG, probe=None, **kw):
    p0, dets, groups, verbs, tense = world(seed, cfg)
    p = p0 if p is None else p
    cap = kl.KimiLinearCaptioner(cfg, p, verb_2_vob_all=tense, device="cpu")
    cap.probe = probe
    res = cap.beam_search_v(dets, groups, verbs, eos_word=EOS, beam_size=K,
                            **kw)
    return p, dets, groups, verbs, cap, res


def judged(p, dets, groups, verbs, cap, res, cfg=RCFG):
    served = {k: getattr(res, k) for k in SERVED}
    return ref.judge_beams(p, cfg, dets, groups, verbs, cap.tense_table.ids,
                           served, EOS)


def steps_of(res):
    return {k: getattr(res, k) for k in ("parents", "step_words",
                                         "step_gates", "step_routes",
                                         "prefix_routes")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_and_decode_match_full_forward(seed, monkeypatch):
    """Prefill, then decode steps through both caches (latents copied,
    KDA states read by parent) whose beams swap parents: every step's
    logits (the served word's log-prob, the lse, the gate log-probs),
    expert choices, selections and scores along the final paths agree
    with the reference's full forward of each path."""
    parents = []
    get = kl.KdaState.__getitem__

    def seen(self, rows):
        parents.append(rows.clone())
        return get(self, rows)
    monkeypatch.setattr(kl.KdaState, "__getitem__", seen)
    out = decode(seed)
    ident = torch.arange(parents[0].shape[0])
    assert any(not torch.equal(r, ident) for r in parents[1:])
    j = judged(*out)
    assert float(j["logit"].max()) < TOL
    assert float(j["beam"].max()) < TOL
    assert float(j["route"].max()) < TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_beam_matches_reference_search(seed):
    """The served beams are the reference's own joint beam search's
    (prefix worked once a job, its KDA states taken by every beam):
    words, gates and scores, where its search meets no near tie."""
    p, dets, groups, verbs, cap, res = decode(seed)
    words, gates, scores, margin = ref.beam_search(
        p, RCFG, dets, groups, verbs, cap.tense_table.ids, K)
    clear = margin > 1e-4
    assert clear.any()
    assert torch.equal(words[clear], res.words[clear])
    assert torch.equal(gates[clear], res.gates[clear])
    torch.testing.assert_close(scores[clear], res.scores[clear], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_joint_cut_at_every_step(seed):
    """The beams every step kept are the reference's own K best children
    of the beams live at that step, rebuilt from the parent pointers."""
    p, dets, groups, verbs, cap, res = decode(seed)
    for t in range(1, CFG.seq_len):
        gap, own = ref.judge_cut(p, RCFG, dets, groups, verbs,
                                 cap.tense_table.ids, steps_of(res), t)
        assert float(gap.max()) < TOL
        flat = lambda b, w, g: ((b * CFG.vocab_size + w) * 2  # noqa: E731
                                + g).sort(1).values
        assert torch.equal(flat(*own), flat(res.parents[:, t],
                                             res.step_words[:, t],
                                             res.step_gates[:, t]))


def test_padding_among_detections_is_the_real_tokens_compacted():
    """Padding interleaved among the real detections gives the beams of
    the real ones compacted: the convolutions and the recurrence see only
    real tokens; the prefix's routes come back in the detections' order
    (padding's beside them unread)."""
    p, dets, groups, verbs, tense = world(4)
    cap = kl.KimiLinearCaptioner(CFG, p, verb_2_vob_all=tense, device="cpu")
    lead = cap.beam_search_v(dets, groups, verbs, eos_word=EOS, beam_size=K)
    spread = torch.zeros_like(dets)
    at = {0: [0, 1, 2, 3, 4, 5, 6], 1: [0, 2, 5, 6], 2: [1, 2, 3, 5, 6]}
    for j, pos in at.items():
        spread[j, pos] = dets[j, :len(pos)]
    got = cap.beam_search_v(spread, groups, verbs, eos_word=EOS,
                            beam_size=K)
    assert torch.equal(got.words, lead.words)
    torch.testing.assert_close(got.scores, lead.scores, rtol=1e-5,
                               atol=1e-5)
    for j, pos in at.items():
        assert torch.equal(got.prefix_routes[j, pos],
                           lead.prefix_routes[j, :len(pos)])
    j = judged(p, spread, groups, verbs, cap, got)
    assert float(j["logit"].max()) < TOL


def _recurrence_inputs(g, s_, t_, h=3, d=8, dv=8):
    q = torch.nn.functional.normalize(torch.randn(s_, t_, h, d, generator=g),
                                      dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn(s_, t_, h, d, generator=g),
                                      dim=-1)
    v = torch.randn(s_, t_, h, dv, generator=g)
    gl = -torch.rand(s_, t_, h, d, generator=g) * 0.2
    beta = torch.rand(s_, t_, h, generator=g)
    return q, k, v, gl, beta


def test_recurrence_with_parents_is_a_gather_then_a_step():
    """One position, each row reading its parent's state within its group
    and writing its own in place, equals a copy of the parents' states
    followed by the equation's step (the reference's `kda_step`)."""
    g = torch.Generator().manual_seed(0)
    rows, beam = 12, 3
    q, k, v, gl, beta = _recurrence_inputs(g, rows, 1)
    state = torch.randn(rows, 3, 8, 8, generator=g)
    parent = (torch.arange(rows) // beam * beam
              + torch.tensor([2, 0, 0, 1, 1, 1, 0, 2, 1, 2, 2, 2]))
    want_s, want_o = ref.kda_step(state.clone()[parent], q[:, 0], k[:, 0],
                                  v[:, 0], torch.exp(gl[:, 0]), beta[:, 0])
    o = kda_op.kda_recurrence(q, k, v, gl, beta, state,
                              parent.to(torch.int32),
                              torch.arange(rows, dtype=torch.int32),
                              group=beam)
    torch.testing.assert_close(o[:, 0], want_o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state, want_s, rtol=1e-5, atol=1e-6)


def test_recurrence_over_a_prefix_skips_padding():
    """Positions not valid neither decay nor update the state and output
    0; sequences start from zeros (rows_in -1) and leave their state in
    rows_out."""
    g = torch.Generator().manual_seed(1)
    q, k, v, gl, beta = _recurrence_inputs(g, 2, 5)
    valid = torch.tensor([[1, 0, 1, 1, 0], [1, 1, 1, 0, 0]],
                         dtype=torch.uint8)
    state = torch.full((6, 3, 8, 8), 7.0)
    o = kda_op.kda_recurrence(q, k, v, gl, beta, state,
                              torch.tensor([-1, -1], dtype=torch.int32),
                              torch.tensor([0, 3], dtype=torch.int32),
                              valid)
    for s, row in ((0, 0), (1, 3)):
        st = torch.zeros(3, 8, 8)
        for t in range(5):
            if not valid[s, t]:
                assert float(o[s, t].abs().max()) == 0.0
                continue
            st, want = ref.kda_step(st, q[s, t], k[s, t], v[s, t],
                                    torch.exp(gl[s, t]), beta[s, t])
            torch.testing.assert_close(o[s, t], want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(state[row], st, rtol=1e-5, atol=1e-6)
    assert float((state[[1, 2, 4, 5]] - 7.0).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the layer's input and output stages (ops/kda.py::conv_qkv, gated_norm)
# against the chains of PyTorch operations they replace, as the layer ran
# them before (kept here as written then)
# ---------------------------------------------------------------------------

def _chain_gates(proj, f, a_log, dt_bias, nh, d):
    g = (-torch.exp(a_log.float())[:, None]
         * F.softplus(f.float().unflatten(-1, (nh, d))
                      + dt_bias.float().view(nh, d)))
    return g, torch.sigmoid(proj[..., -nh:].float()).contiguous()


def _chain_short_conv(qkv, w):
    n, kk = qkv.shape[1], w.shape[1]
    xp = F.pad(qkv, (0, 0, kk - 1, 0)).float()
    w = w.float()
    y = xp[:, :n] * w[:, 0]
    for j in range(1, kk):
        y.addcmul_(xp[:, j:j + n], w[:, j])
    return F.silu(y)


def _chain_conv_step(qkv, conv, parent, w):
    window = torch.cat([conv.index_select(0, parent), qkv[:, None]], 1)
    conv.copy_(window[:, 1:])
    return F.silu((window.float() * w.T.float()).sum(1))


def _chain_qkv(y, nh, d):
    hd = nh * d
    q, k, v = (y[..., i * hd:(i + 1) * hd].unflatten(-1, (nh, d))
               for i in range(3))

    def l2(t):
        return t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + 1e-6)
    return l2(q) * d ** -0.5, l2(k), v.contiguous()


def _stage_inputs(dtype, rows, t_, nh=2, d=8, seed=0):
    """in_proj's rows (rows, t_, 3 nh d + 2 d + nh), f, A_log, dt_bias and
    conv weights as `init_kimi_linear_params` draws them, in `dtype`."""
    g = torch.Generator().manual_seed(seed)
    c = 3 * nh * d
    proj = torch.randn(rows, t_, c + 2 * d + nh, generator=g).to(dtype)
    f = torch.randn(rows, t_, nh * d, generator=g).to(dtype)
    a_log = kl.draw_leaf("A_log", (nh,), g)
    dt_bias = kl.draw_leaf("dt_bias", (nh * d,), g)
    w = kl.draw_leaf("conv", (c, 4), g).to(dtype)
    return proj, f, a_log, dt_bias, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_conv_qkv_plain_is_the_chain_it_replaces(mode, dtype):
    """Prefill: prefixes of 1, 2, 3, 4 and 100 real tokens of 100, their
    last 3 real inputs (zeros where fewer) into their window rows, the
    rows no prefix writes untouched. Decode: rows reading windows of other
    rows of their group that are themselves rewritten (read before write).
    q, k, v, g, beta and the windows equal the old chain's bit for bit at
    the real positions, zeros past them; the wrapper runs the plain
    version for CPU tensors and counts no launch."""
    nh, d = 2, 8
    c = 3 * nh * d
    if mode == "prefill":
        lengths = torch.tensor([1, 2, 3, 4, 100], dtype=torch.int32)
        proj, f, a_log, dt_bias, w = _stage_inputs(dtype, 5, 100, nh, d)
        rows_out = torch.tensor([0, 2, 4, 6, 9], dtype=torch.int32)
        conv = torch.full((11, 3, c), 7.0).to(dtype)
        want_conv = conv.clone()
        # the old kda_prefill's window and convolutions
        real = torch.arange(100)[None] < lengths[:, None].long()
        qkv = proj[..., :c]
        idx = real.sum(1, keepdim=True) + torch.arange(-3, 0)
        last = qkv.gather(1, idx.clamp_min(0)[..., None].expand(-1, -1, c))
        want_conv[rows_out.long()] = torch.where((idx >= 0)[..., None], last,
                                                 0.0)
        y = _chain_short_conv(qkv, w)
        kw = dict(lengths=lengths, rows_out=rows_out)
    else:
        beam, rows = 3, 12
        proj, f, a_log, dt_bias, w = _stage_inputs(dtype, rows, 1, nh, d)
        parent = (torch.arange(rows) // beam * beam + torch.tensor(
            [2, 0, 0, 1, 1, 1, 0, 2, 1, 2, 2, 2])).to(torch.int32)
        conv = torch.randn(rows, 3, c,
                           generator=torch.Generator().manual_seed(1)
                           ).to(dtype)
        want_conv = conv.clone()
        real = torch.ones(rows, 1, dtype=torch.bool)
        y = _chain_conv_step(proj[:, 0, :c], want_conv, parent, w)[:, None]
        assert torch.equal(want_conv[:, :2], conv[parent.long(), 1:])
        kw = dict(parent=parent, group=beam)
    want = _chain_qkv(y, nh, d) + _chain_gates(proj, f, a_log, dt_bias, nh, d)
    rate = torch.exp(a_log.float())
    before = kda_op.conv_qkv.launches
    for fn in (kda_op.conv_qkv_plain, kda_op.conv_qkv):
        got_conv = conv.clone()
        got = fn(proj, f, rate, dt_bias, w, got_conv, **kw)
        assert torch.equal(got_conv, want_conv)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert torch.equal(a[real], b[real])
            assert not a[~real].any()
    assert kda_op.conv_qkv.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lead", [(12,), (5, 7)], ids=["decode", "prefill"])
def test_gated_norm_plain_is_the_chain_it_replaces(lead, dtype):
    """The recurrence's o through the old kda_out's RMSNorm and gate, up to
    o_proj's input: equal bit for bit; the wrapper runs the plain version
    for CPU tensors and counts no launch."""
    g = torch.Generator().manual_seed(2)
    nh, d, eps = 3, 8, 1e-5
    o = torch.randn(*lead, nh, d, generator=g)
    gate = torch.randn(*lead, nh * d, generator=g).to(dtype)
    weight = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)
    want = F.rms_norm(o, (d,), weight.float(), eps)
    want = (want * torch.sigmoid(gate.float().unflatten(-1, (nh, d)))
            ).flatten(-2).to(dtype)
    before = kda_op.gated_norm.launches
    for fn in (kda_op.gated_norm_plain, kda_op.gated_norm):
        got = fn(o, gate, weight, eps)
        assert got.dtype == dtype and torch.equal(got, want)
    assert kda_op.gated_norm.launches == before


def test_stages_refuse_devices_they_cannot_run_on():
    """No fallback: a tensor neither on the CPU nor on a card raises."""
    proj, f, a_log, dt_bias, w = (t.to("meta") for t in _stage_inputs(
        torch.float32, 5, 1))
    conv = torch.empty(5, 3, 48, device="meta")
    with pytest.raises(ValueError):
        kda_op.conv_qkv(proj, f, a_log, dt_bias, w, conv,
                        parent=torch.zeros(5, dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError):
        kda_op.gated_norm(torch.empty(5, 2, 8, device="meta"),
                          torch.empty(5, 16, device="meta"),
                          torch.empty(8, device="meta"), 1e-5)


def test_decode_graphs_count_every_kda_kernel():
    """A decode shape's graphs replay the launch counts of the layer's
    three kernels: the recurrence, the input stage and the gated norm."""
    _, _, _, _, cap, _ = decode(0)
    (buf,) = cap._shapes.values()
    assert buf.graphs.counted == (kda_op.kda_recurrence, kda_op.conv_qkv,
                                  kda_op.gated_norm)


@pytest.mark.parametrize("share", [4, 8])
def test_expert_shares_add_up_to_the_whole_layer(share):
    """Guide section 4's share test: each chip of the deployment holds
    `share` of the 16 experts and computes its part; the shares' routed
    parts, with the shared expert counted once, add up to the uncut
    reference's whole layer (every expert held)."""
    full = dataclasses.replace(CFG, experts_held=16)
    lp = world(2, full)[0]["layers"][1]
    x = torch.randn(11, CFG.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    shared = kv.swiglu(x, lp["shared_gate_up"], lp["shared_down"])
    total = shared.clone()
    for first in range(0, 16, share):
        part = dict(lp, experts_gate_up=lp["experts_gate_up"][
            first:first + share], experts_down=lp["experts_down"][
                first:first + share])
        cfg = dataclasses.replace(CFG, experts_held=share,
                                  first_expert=first)
        y, idx = kv.moe(part, cfg, x)
        total += y - shared
        # the program's part is the reference's at the same share
        y_ref, _, idx_ref = ref.moe(ref.vl.upcast(part),
                                    dataclasses.asdict(cfg), x)
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(idx.sort(1).values, idx_ref.sort(1).values)
    whole, _, _ = ref.moe(ref.vl.upcast(lp), dataclasses.asdict(full), x)
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.name()] += 1
        return func(*args, **(kwargs or {}))


def test_kimi_vl_launches_and_outputs_as_before():
    """Kimi-VL's tiny beam (tests/test_torch_kimi_vl.py's world, seed 0)
    through the facade with the hybrid's seams: the aten operations and
    every output equal to those recorded on the tree before them
    (tests/data/kimi_vl_aten_counts.json, kimi_vl_tiny_beam.npz)."""
    import test_torch_kimi_vl as tv
    p, dets, groups, verbs, tense = tv.world(0)
    cap = kv.KimiVLCaptioner(tv.CFG, p, verb_2_vob_all=tense, device="cpu")
    cap.beam_search_v(dets, groups, verbs, eos_word=tv.EOS, beam_size=tv.K)
    with _Count() as mode:
        res = cap.beam_search_v(dets, groups, verbs, eos_word=tv.EOS,
                                beam_size=tv.K)
    with open(os.path.join(DATA, "kimi_vl_aten_counts.json")) as f:
        assert dict(mode.counts) == json.load(f)
    before = np.load(os.path.join(DATA, "kimi_vl_tiny_beam.npz"))
    assert sorted(before.files) == sorted(res._fields)
    for name in res._fields:
        assert torch.equal(getattr(res, name),
                           torch.from_numpy(before[name])), name


def test_spans_and_counters():
    """`vlm.kda` spans the KDA layers (prefill, decode, the state's
    reorder) with the state bytes the recurrence read and wrote, the conv
    windows gathered, and 0 state bytes moved by the reorders; the MLA
    layers stay under `vlm.attn`; the device counts count held experts."""
    obs.RECORDER.clear()
    t0 = obs.time.perf_counter_ns()
    p, dets, groups, verbs, cap, res = decode(0)
    spans = obs.summary(t0)
    for name in ("vlm.prefill", "vlm.kda", "vlm.attn", "vlm.moe",
                 "vlm.cache", "vlm.head"):
        assert name in spans, name
    counts = spans["vlm.kda"]["counts"]
    lk, rows, nh, d = 4, 3 * K, CFG.kda_heads, CFG.kda_head_dim
    state = nh * d * d * 4
    assert counts["kda_state_bytes"] == lk * (3 * state
                                              + CFG.seq_len * 2 * rows
                                              * state)
    assert counts["state_moved_bytes"] == 0
    assert counts["conv_moved_bytes"] == lk * CFG.seq_len * rows * 3 * (
        3 * nh * d) * 4
    mla_layers = 2
    assert spans["vlm.attn"]["count"] == mla_layers * (1 + CFG.seq_len)
    assert spans["vlm.kda"]["count"] >= lk * (1 + CFG.seq_len)
    n = cap.device_counts()
    # pairs routed to a held expert only: fewer than every routed pair
    assert 0 < n["prefill_pairs"] < 16 * CFG.num_experts_per_tok * 5
    assert 0 < n["decode_pairs"] < (3 * K * CFG.seq_len
                                    * CFG.num_experts_per_tok * 5)


def test_reorder_copies_no_state():
    """The beam's reorder of the KDA states takes parent pointers only: the
    states and conv windows after it are the same tensors in the same
    storage, no operation touches them, and `state_moved_bytes` reads
    what a reorder copies (a copying reorder reads its bytes)."""
    n, rows = 2, 6
    st = kl.KdaState(torch.randn(n, rows, 2, 4, 4), torch.randn(n, rows, 3, 8),
                     torch.arange(rows))
    cache = kl.HybridCache(kv.LatentCache(torch.zeros(4, rows, 1, 5),
                                          torch.zeros(4, rows, 1, 5), 2), st)
    pick = torch.tensor([0, 0, 2, 3, 3, 5])
    touched = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for a in list(args) + list((kwargs or {}).values()):
                if isinstance(a, torch.Tensor) and (
                        a.untyped_storage().data_ptr()
                        in (st.state.untyped_storage().data_ptr(),
                            st.conv.untyped_storage().data_ptr())):
                    touched.append(func.name())
            return func(*args, **(kwargs or {}))
    obs.RECORDER.clear()
    t0 = obs.time.perf_counter_ns()
    with Watch():
        out = cache[pick]
    assert not touched
    assert out.kda.state is st.state and out.kda.conv is st.conv
    assert torch.equal(out.kda.parent, pick)
    assert obs.summary(t0)["vlm.kda"]["counts"]["state_moved_bytes"] == 0
    copied = kl.KdaState(st.state[:, pick], st.conv[:, pick], pick)
    assert kl.moved_bytes(st, copied) == (st.state.nbytes + st.conv.nbytes)


def test_decode_graph_replays_advance_launch_counters():
    """A decode layer's graph replay adds to the launch counters what its
    capture added (the KDA kernel's wrapper is not called on a replay):
    eager on a shape's first batch, captured on its second, replayed
    after, the counts as if every batch ran eagerly."""
    class FakeGraph:
        def capture(self, fn):
            fn()

        def replay(self):
            pass
    ctr = type("Ctr", (), {})()
    ctr.launches, ctr.other = 0, 5
    ran = []

    def fn():
        ran.append(1)
        ctr.launches += 2
    g = kv.DecodeGraphs(torch.device("cpu"), counted=(ctr,),
                        graph=FakeGraph)
    for batch in range(4):
        g.live = batch > 0
        for key in (("attn", 0, 1), ("attn", 1, 1)):
            g.run(key, fn)
    assert len(ran) == 4 and (ctr.launches, ctr.other) == (16, 5)
    # off the card without a stand-in, every call runs as it is
    eager = kv.DecodeGraphs(torch.device("cpu"), counted=(ctr,))
    eager.live = True
    eager.run(("moe", 0, 0), fn)
    assert len(ran) == 5 and not eager.graphs


def test_kda_parents_counts_each_steps_distinct_parents():
    """`kda_parents` counts the states the decode's KDA calls read: one a
    job at step 0 (the prefill's), then each step's distinct parents."""
    _, _, _, _, cap, res = decode(0)
    want = res.parents.shape[0]
    for t in range(CFG.seq_len - 1):
        want += sum(len(set(res.parents[j, t].tolist()))
                    for j in range(res.parents.shape[0]))
    assert cap.device_counts()["kda_parents"] == want
    assert want < res.parents.shape[0] * K * CFG.seq_len


def test_probe_is_the_recurrence_as_run():
    """The probe copies one KDA layer's step at one job's rows as the
    timed path ran it: held to the equation from the same inputs it reads
    within float32's rounding; with the state kept in bf16 the equation
    lies far off."""
    _, _, _, _, _, res = decode(1, probe=(2, 3, 1))
    probe = res.probe
    assert probe is not None and probe["state"].shape == (
        K, CFG.kda_heads, CFG.kda_head_dim, CFG.kda_head_dim)
    gap, _ = ref.judge_recurrence(probe, RCFG)
    assert float(gap) < 1e-5
    _, bf16 = ref.judge_recurrence(probe, dict(RCFG, kda_state="bfloat16"))
    gap_bf16, _ = ref.judge_recurrence(probe, RCFG, bf16)
    with open(LIMITS) as f:
        limit = json.load(f)["state_gap"]
    assert float(gap) < limit < float(gap_bf16)


def test_run_stream_words_are_the_best_beams():
    """`EvalPipeline.run_stream` with the hybrid's facade, at tiny shapes:
    every yielded batch's words are its beam's best, and the cell's checks
    pass, `state_gap` among them (the tiny Kimi-Linear cell's driver on
    the CPU; this process holds JAX, so not through `vsrbench.run`, which
    refuses to report then)."""
    import tempfile
    from types import SimpleNamespace
    from vsrbench import layout
    from vsrbench.drivers import eval_stream_kla
    from vsrbench.tests.tiny_kla import CELL, tiny_kla_root
    with tempfile.TemporaryDirectory() as d:
        cell = layout.cell(CELL, tiny_kla_root(d))
        args = SimpleNamespace(seed=2 ** 40 + 9, seconds=0.5, trace=0)
        line, checks = eval_stream_kla.run(cell, args, torch.device("cpu"),
                                           0.0)
    assert line["correct"] is True and line["failed"] == 0
    assert checks["yield_exact"]["value"] == 0
    assert checks["state_gap"]["value"] < 1e-5
    assert line["attempted"] > 0


def test_reference_copy_is_the_same():
    assert filecmp.cmp(os.path.join(REPO, "reference_torch",
                                    "kimi_linear_lm.py"),
                       os.path.join(REPO, "vsrbench", "reference",
                                    "kimi_linear_lm.py"), shallow=False)


# ---------------------------------------------------------------------------
# faults that a number of the cell must catch
# ---------------------------------------------------------------------------

def fault_stale_parent(monkeypatch):
    """Each row goes on from its own KDA state, not its parent's."""
    monkeypatch.setattr(kl.KdaState, "__getitem__",
                        lambda self, rows: kl.KdaState(self.state, self.conv,
                                                       self.parent))


def fault_no_decay(monkeypatch):
    project = kl.kda_project

    def no_decay(lp, cfg, x):
        qkv, g, beta, gate = project(lp, cfg, x)
        return qkv, torch.zeros_like(g), beta, gate
    monkeypatch.setattr(kl, "kda_project", no_decay)


def fault_conv_state_dropped(monkeypatch):
    """Each decode step's convolution window starts from zeros, not from
    the parent's last inputs."""
    step = kl.conv_step
    monkeypatch.setattr(kl, "conv_step", lambda qkv, conv, parent, w: step(
        qkv, torch.zeros_like(conv), parent, w))


def fault_rope_on_mla(monkeypatch):
    """MLA turned by RoPE at each token's position (the prefix's real
    tokens 0 .., a step N_real + t), as Kimi-VL's."""
    where = {}
    decode_ = kl.KimiLinearCaptioner._decode

    def at_step(self, buf, statics, cache, t, k, job):
        where["rot"] = kv.rope_angles(statics.prefix.n_real[job] + t,
                                      self.cfg)
        return decode_(self, buf, statics, cache, t, k, job)
    pre, dec = kl.mla_prefill, kl.mla_decode
    monkeypatch.setattr(kl.KimiLinearCaptioner, "_decode", at_step)
    monkeypatch.setattr(kl, "mla_prefill", lambda lp, cfg, x, rot, mask: pre(
        lp, cfg, x, kv.rope_angles(torch.arange(x.shape[1]).expand(
            x.shape[0], -1), cfg), mask))
    monkeypatch.setattr(kl, "mla_decode", lambda lp, cfg, x, rot, *a: dec(
        lp, cfg, x, where["rot"], *a))


@pytest.mark.parametrize("fault", [fault_stale_parent, fault_no_decay,
                                   fault_conv_state_dropped,
                                   fault_rope_on_mla],
                         ids=lambda f: f.__name__[6:])
def test_fault_breaks_a_check(fault, monkeypatch):
    """Each fault puts the served beams beyond at least one of the cell's
    limits (`vsrbench/limits/vsr-kimilinear.kda-stream-b128.json`)."""
    with open(LIMITS) as f:
        limits = json.load(f)
    fault(monkeypatch)
    j = judged(*decode(0))
    assert (float(j["logit"].max()) > limits["logit_gap"]
            or float(j["beam"].max()) > limits["beam_gap"]
            or float(j["route"].max()) > limits["route_gap"])


def test_non_held_experts_computed_break_a_check():
    """A program that adds the parts of experts it does not hold (all 16
    computed where the chip holds 8) lies beyond the cell's limits against
    the reference of the held share."""
    with open(LIMITS) as f:
        limits = json.load(f)
    full = dataclasses.replace(CFG, experts_held=16)
    p = world(0, full)[0]
    held = dict(p, layers=[dict(lp, experts_gate_up=lp["experts_gate_up"][:8],
                                experts_down=lp["experts_down"][:8])
                           if "router" in lp else lp for lp in p["layers"]])
    out = decode(0, p=p, cfg=full)
    j = judged(held, *out[1:])
    assert (float(j["logit"].max()) > limits["logit_gap"]
            or float(j["beam"].max()) > limits["beam_gap"])
