"""Kimi-VL-A3B's language model as the port's caption decoder
(`models/kimi_vl.py`) against its plain reference
(`reference_torch/kimi_vl_lm.py`) at a tiny size on the CPU, in float32:
prefill and cached decode steps against the reference's full forward
along the served beams (whose parents swap), the router, the joint beam
against the reference's own search, the eval pipeline's stream, and
faults that each break a check."""
from __future__ import annotations

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from reference_torch import kimi_vl_lm as ref
from vsrcic_tpu_torch.models import kimi_vl as kv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = kv.KimiVLConfig(vocab_size=50, hidden_size=64, intermediate_size=96,
                      moe_intermediate_size=32, num_hidden_layers=3,
                      num_attention_heads=4, n_shared_experts=1,
                      n_routed_experts=8, num_experts_per_tok=2,
                      kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, det_feat_size=24,
                      seq_len=6)
RCFG = dataclasses.asdict(CFG)
EOS = 3
K = 3
# float32 program against the float32 reference: the same sums in other
# orders (cuBLAS-free CPU products, the absorbed decode against the
# expanded full forward), so a few float32 ulps of the logits
TOL = 1e-4
SERVED = ("words", "gates", "word_logps", "gate_logps", "scores", "head",
          "head_ids", "routes", "prefix_routes")


def world(seed=0):
    g = torch.Generator().manual_seed(seed)
    p = kv.init_kimi_vl_params(g, CFG, dtype=torch.float32, std=0.2,
                               bias_std=0.05)
    n_jobs, n, n_groups, m = 3, 7, 4, 5
    dets = torch.randn(n_jobs, n, CFG.det_feat_size, generator=g)
    real = torch.tensor([7, 4, 5])
    dets *= (torch.arange(n)[None] < real[:, None])[..., None]
    groups = torch.randn(n_jobs, n_groups, m, CFG.det_feat_size, generator=g)
    groups[:, :, 3:] = 0
    groups[1, 2:] = 0
    verbs = torch.full((n_jobs, n_groups), -1)
    verbs[0, 1] = 2
    verbs[2, 0] = 1
    rng = np.random.RandomState(seed)
    tense = {str(v): (4 + rng.choice(CFG.vocab_size - 4, 3,
                                     replace=False)).tolist()
             for v in range(1, 4)}
    return p, dets, groups, verbs, tense


def decode(seed=0, **kw):
    p, dets, groups, verbs, tense = world(seed)
    cap = kv.KimiVLCaptioner(CFG, p, verb_2_vob_all=tense, device="cpu")
    res = cap.beam_search_v(dets, groups, verbs, eos_word=EOS, beam_size=K,
                            **kw)
    return p, dets, groups, verbs, cap, res


def judged(p, dets, groups, verbs, cap, res):
    served = {k: getattr(res, k) for k in SERVED}
    return ref.judge_beams(p, RCFG, dets, groups, verbs, cap.tense_table.ids,
                           served, EOS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cached_decode_matches_full_forward(seed, monkeypatch):
    """Prefill, then cached decode steps whose beams swap parents: every
    step's logits (the served word's log-prob, the lse, the gate
    log-probs), expert choices, selections and scores along the final
    paths agree with the reference's full forward of each path."""
    reorders = []
    get = kv.LatentCache.__getitem__

    def seen(self, rows):
        reorders.append(rows.clone())
        return get(self, rows)
    monkeypatch.setattr(kv.LatentCache, "__getitem__", seen)
    out = decode(seed)
    ident = torch.arange(reorders[0].shape[0])
    assert any(not torch.equal(r, ident) for r in reorders[1:])
    j = judged(*out)
    assert float(j["logit"].max()) < TOL
    assert float(j["beam"].max()) < TOL
    assert float(j["route"].max()) < TOL


def test_router_bias_normalisation_and_scale():
    """The router against its published equations: sigmoid scores, the top
    k of score + correction bias, the chosen scores normalised and
    scaled."""
    g = torch.Generator().manual_seed(3)
    h, e = CFG.hidden_size, CFG.n_routed_experts
    lp = {"router": torch.randn(e, h, generator=g) * 0.1,
          "router_bias": torch.zeros(e)}
    x = torch.randn(9, h, generator=g)
    s = torch.sigmoid(x @ lp["router"].T)
    # a bias that makes the last-ranked expert of every token first
    lp["router_bias"] = torch.zeros(e)
    worst = s.argmin(1)
    w0, idx0 = kv.route(lp, CFG, x)
    lp["router_bias"][worst[0]] = 2.0
    w, idx = kv.route(lp, CFG, x)
    assert int(idx[0, 0]) == int(worst[0])
    chosen = s.gather(1, idx)
    want = chosen / chosen.sum(1, keepdim=True) * CFG.routed_scaling_factor
    torch.testing.assert_close(w, want, rtol=1e-6, atol=1e-6)
    assert torch.allclose(w.sum(1), torch.full((9,),
                                               CFG.routed_scaling_factor))
    plain = (s.topk(CFG.num_experts_per_tok, -1).indices)
    assert torch.equal(idx0.sort(1).values, plain.sort(1).values)
    # the MoE layer along these choices, against the reference's
    lp = world(4)[0]["layers"][1]
    y, ids = kv.moe(lp, CFG, x)
    y_ref, gap, ids_ref = ref.moe(ref.upcast(lp), RCFG, x)
    assert torch.equal(ids.sort(1).values, ids_ref.sort(1).values)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    assert float(gap.max()) == 0.0


@pytest.mark.parametrize("seed", [0, 5])
def test_beam_matches_reference_search(seed):
    """The served beams are the reference's own joint beam search's:
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


def steps_of(res):
    return {k: getattr(res, k) for k in ("parents", "step_words",
                                         "step_gates", "step_routes",
                                         "prefix_routes")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_joint_cut_at_every_step(seed):
    """The beams every step kept, rebuilt from the parent pointers, are
    the reference's own K best children of the beams live at that step;
    the pointers rebuild the final paths."""
    p, dets, groups, verbs, cap, res = decode(seed)
    tense = cap.tense_table.ids
    for t in range(1, CFG.seq_len):
        gap, own = ref.judge_cut(p, RCFG, dets, groups, verbs, tense,
                                 steps_of(res), t)
        assert float(gap.max()) < TOL
        flat = lambda b, w, g: ((b * CFG.vocab_size + w) * 2  # noqa: E731
                                + g).sort(1).values
        assert torch.equal(flat(*own), flat(res.parents[:, t],
                                             res.step_words[:, t],
                                             res.step_gates[:, t]))
    cur = torch.arange(K).expand(dets.shape[0], K)
    for t in reversed(range(CFG.seq_len)):
        assert torch.equal(res.step_words[:, t].gather(1, cur),
                           res.words[:, :, t])
        cur = res.parents[:, t].gather(1, cur)


def fault_each_beam_extended_alone(monkeypatch):
    """From step 1 each beam offers the joint selection only its best
    child, so every beam extends itself: each kept child is its own
    prefix's best (what `judge_beams` checks), not the joint top K."""
    cands = kv.topk_candidates
    calls = [0]

    def alone(vals, ids, lse, glp, verb_curr, tgt, k):
        ci, cw, g = cands(vals, ids, lse, glp, verb_curr, tgt, k)
        calls[0] += 1
        if calls[0] % CFG.seq_len == 1:
            return ci, cw, g
        cw = torch.where(torch.arange(cw.shape[1]) == cw.argmax(1,
                                                                keepdim=True),
                         cw, -torch.inf)
        g = torch.where(torch.arange(2) == g.argmax(1, keepdim=True), g,
                        -torch.inf)
        return ci, cw, g
    monkeypatch.setattr(kv, "topk_candidates", alone)


def test_cut_sees_each_beam_extended_alone(monkeypatch):
    """Only the joint cut sees beams that extend themselves alone: every
    kept child is its prefix's best, so `judge_beams` finds nothing."""
    import json
    with open(os.path.join(REPO, "vsrbench", "limits",
                           "vsr-kimivl.vlm-stream-b256.json")) as f:
        limits = json.load(f)
    fault_each_beam_extended_alone(monkeypatch)
    p, dets, groups, verbs, cap, res = out = decode(0)
    j = judged(*out)
    assert float(j["beam"].max()) < TOL
    worst = max(float(ref.judge_cut(p, RCFG, dets, groups, verbs,
                                    cap.tense_table.ids, steps_of(res),
                                    t)[0].max())
                for t in range(1, CFG.seq_len))
    assert worst > limits["cut_gap"]


def test_padding_and_counts():
    """Padded detections change nothing but the counts: a job's beams are
    the same alone with its padding cut off."""
    p, dets, groups, verbs, cap, res = decode(0)
    one = cap.beam_search_v(dets[1:2, :4], groups[1:2], verbs[1:2],
                            eos_word=EOS, beam_size=K)
    assert torch.equal(one.words[0], res.words[1])
    torch.testing.assert_close(one.scores[0], res.scores[1], rtol=1e-5,
                               atol=1e-5)
    counts = cap.device_counts()
    assert counts["prefix_tokens"] == 16 + 4
    assert counts["prefill_pairs"] == 20 * CFG.num_experts_per_tok * 2
    assert counts["decode_pairs"] == ((3 + 1) * K * CFG.seq_len
                                      * CFG.num_experts_per_tok * 2)


def fault_route_top_k_less_one(monkeypatch):
    """The router's last choice given no weight (top 1 for top 2, as top 5
    for top 6 at the published size)."""
    route = kv.route

    def less(lp, cfg, x):
        w, idx = route(lp, cfg, x)
        w = w.clone()
        w[:, -1] = 0
        return w / w.sum(1, keepdim=True) * cfg.routed_scaling_factor, idx
    monkeypatch.setattr(kv, "route", less)


def fault_no_shared_expert(monkeypatch):
    moe = kv.moe

    def no_shared(lp, cfg, x, valid=None, counts=None):
        y, idx = moe(lp, cfg, x, valid, counts)
        return y - kv.swiglu(x, lp["shared_gate_up"], lp["shared_down"]), idx
    monkeypatch.setattr(kv, "moe", no_shared)


def fault_no_rope(monkeypatch):
    monkeypatch.setattr(kv, "apply_rope", lambda x, rot: x)


def fault_stale_cache_row(monkeypatch):
    """The beams' own latents left where they were at each selection."""
    get = kv.LatentCache.__getitem__
    monkeypatch.setattr(kv.LatentCache, "__getitem__",
                        lambda self, rows: get(self,
                                               torch.arange(rows.shape[0])))


@pytest.mark.parametrize("fault", [fault_route_top_k_less_one,
                                   fault_no_shared_expert, fault_no_rope,
                                   fault_stale_cache_row],
                         ids=lambda f: f.__name__[6:])
def test_fault_breaks_a_check(fault, monkeypatch):
    """Each fault puts the served beams beyond at least one of the cell's
    limits (`vsrbench/limits/vsr-kimivl.vlm-stream-b256.json`)."""
    import json
    with open(os.path.join(REPO, "vsrbench", "limits",
                           "vsr-kimivl.vlm-stream-b256.json")) as f:
        limits = json.load(f)
    fault(monkeypatch)
    j = judged(*decode(0))
    assert (float(j["logit"].max()) > limits["logit_gap"]
            or float(j["beam"].max()) > limits["beam_gap"]
            or float(j["route"].max()) > limits["route_gap"])


def test_reference_copy_is_the_same():
    assert filecmp.cmp(os.path.join(REPO, "reference_torch", "kimi_vl_lm.py"),
                       os.path.join(REPO, "vsrbench", "reference",
                                    "kimi_vl_lm.py"), shallow=False)


def test_run_stream_words_are_the_best_beams():
    """`EvalPipeline.run_stream` with the decoder's facade, at tiny shapes:
    every yielded batch's words are its beam's best, and the cell's checks
    pass (the tiny Kimi-VL cell's driver on the CPU; this process holds
    JAX, so not through `vsrbench.run`, which refuses to report then)."""
    import tempfile
    from types import SimpleNamespace
    from vsrbench import layout
    from vsrbench.drivers import eval_stream_vlm
    from vsrbench.tests.tiny_vlm import CELL, tiny_vlm_root
    with tempfile.TemporaryDirectory() as d:
        cell = layout.cell(CELL, tiny_vlm_root(d))
        args = SimpleNamespace(seed=2 ** 40 + 7, seconds=0.5, trace=0)
        line, checks = eval_stream_vlm.run(cell, args, torch.device("cpu"),
                                           0.0)
    assert line["correct"] is True and line["failed"] == 0
    assert checks["yield_exact"]["value"] == 0
    assert line["attempted"] > 0
