"""The Kimi-VL cell's files: the yardstick against hand counts at a tiny
shape, the generator's inputs, the metrics' readers on a made-up slice,
and runs on the CPU, right and with a fault that the limits catch."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from vsrbench import harness, layout
from vsrbench import yardstick_vlm as yv
from vsrbench.drivers import eval_stream, eval_stream_vlm
from vsrbench.tests.tiny import run_cell
from vsrbench.tests.tiny_vlm import CELL, tiny_vlm_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_vlm_root(tmp_path_factory.mktemp("tiny_vlm"))


def tiny_model(root):
    return yv.model(layout.cell(CELL, root).config)


def test_yardstick_hand_counts(root):
    """hidden 64, 4 heads of 16 + 8, latent 32, v 16, dense 96, experts
    of 32 (8, top 2, 1 shared), vocab 50, 3 layers (1 dense), det 16."""
    c = tiny_model(root)
    proj = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    assert yv.attn_proj_macs(c) == proj == 16896
    # absorbed: q, kv_a, W_UK, scores and latent output over 10 positions,
    # W_UV, o
    assert yv.attn_decode_macs(c, 10) == (
        64 * 96 + 64 * 40 + 4 * 16 * 32 + 4 * 10 * 40 + 4 * 10 * 32
        + 4 * 32 * 16 + 4 * 16 * 64)
    assert yv.expert_macs(c) == 3 * 64 * 32
    assert yv.mlp_macs(c, 0) == 3 * 64 * 96
    assert yv.mlp_macs(c, 1) == 64 * 8 + 3 * 3 * 64 * 32
    assert yv.projector_macs(c) == 16 * 64 + 64 * 64
    # one job of 3 real detections: projector, 3 layers, causal pairs 6
    want = 3 * yv.projector_macs(c) + sum(
        3 * (proj + yv.mlp_macs(c, i)) + 6 * 4 * (24 + 16) for i in range(3))
    assert yv.prefill_flops(c, [3]) == 2.0 * want
    # beam 2 over seq_len 6 steps, context 3 + t + 1
    head = 64 * 52
    want = sum(2 * (3 * yv.attn_decode_macs(c, 3 + t + 1)
                    + sum(yv.mlp_macs(c, i) for i in range(3)) + head)
               for t in range(6))
    assert yv.decode_flops(c, [3], 2) == 2.0 * want
    assert yv.control_flops(c, 2, 10, 4) == 2.0 * 80 * yv.projector_macs(c)


def test_bounds_take_the_larger(root):
    c = tiny_model(root)
    ops = 2.0 * (100 + 1 * 10) * yv.expert_macs(c) / yv.BF16_DENSE_FLOPS
    nbytes = 2 * ((5 + 1 * 2) * yv.expert_macs(c) + 110 * 2 * 64)
    assert yv.moe_bound_s(c, 100, 10, 5, 2) == max(
        ops, nbytes / yv.HBM_BYTES_PER_S)
    assert yv.mla_prefill_bound_s(c, [3, 4]) > 0
    assert yv.mla_decode_bound_s(c, [3], 2) > 0


@pytest.mark.parametrize("seed", (7, 2 ** 31 + 11, 2 ** 40 + 3))
def test_same_seed_same_inputs(root, seed):
    cell = layout.cell(CELL, root)
    dev = torch.device("cpu")
    a = eval_stream.make_batch(cell.config, cell.traffic, seed, 0, dev)
    b = eval_stream.make_batch(cell.config, cell.traffic, seed, 0, dev)
    assert torch.equal(a.dets, b.dets) and torch.equal(a.seqs, b.seqs)
    wa = eval_stream_vlm.make_weights(cell.config, seed, dev)
    wb = eval_stream_vlm.make_weights(cell.config, seed, dev)
    assert torch.equal(wa["kimi"]["layers"][1]["experts_down"],
                       wb["kimi"]["layers"][1]["experts_down"])
    assert torch.equal(wa["kimi"]["lm_head"], wb["kimi"]["lm_head"])


def test_metrics_read_a_slice(root):
    cell = layout.cell(CELL, root)
    tr = cell.traffic
    pool = [SimpleNamespace(n_real=[3, 5, 7, 4, 6, 7], flops=1e9)] * 2
    counts = {"prefix_tokens": 64, "prefill_pairs": 256,
              "prefill_experts_hit": 30, "decode_pairs": 2880,
              "decode_experts_hit": 190, "vocab": 0}
    ctx = SimpleNamespace(config=cell.config, traffic=tr, units=4,
                          window_s=2.0, pool=pool,
                          shape=eval_stream.shape_of(cell.config, tr),
                          slice=SimpleNamespace(counters=counts, window_s=1.0,
                                                kernels=[("k", 0.0, 1.0)],
                                                busy_s=0.25),
                          span_ms={"vlm.attn": 3.0, "vlm.moe": 2.0})
    got = harness.read_metrics(cell, SimpleNamespace(**vars(ctx)))
    assert got["mfu_pct.vlm"]["value"] == pytest.approx(
        100 * 4e9 / (2.0 * yv.BF16_DENSE_FLOPS))
    for name in ("moe_roofline_pct.vlm", "mla_roofline_pct.vlm"):
        assert 0 < got[name]["value"] < 100
    assert got["device_idle_pct.vlm"]["value"] == 75.0
    # the parent's slice: no spans, no counts: nothing read, nothing raised
    ctx.span_ms = {}
    ctx.slice = SimpleNamespace(counters=None, window_s=1.0, kernels=[],
                                busy_s=0.0)
    assert "moe_roofline_pct.vlm" not in harness.read_metrics(cell, ctx)


def test_cell_runs_correct(root):
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is True
    assert set(line["checks"]) == set(json.loads(
        (root / "vsrbench" / "limits" / (CELL + ".json")).read_text()))


def test_stale_cache_is_caught(root, monkeypatch):
    """The beams' own latents left in place at each selection: the cell
    comes out not correct."""
    from vsrcic_tpu_torch.models import kimi_vl as kv
    get = kv.LatentCache.__getitem__
    monkeypatch.setattr(kv.LatentCache, "__getitem__",
                        lambda self, rows: get(self,
                                               torch.arange(rows.shape[0])))
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is False
    assert (line["checks"]["logit_gap"]["value"]
            > line["checks"]["logit_gap"]["limit"])


def test_no_shared_expert_is_caught(root, monkeypatch):
    from vsrcic_tpu_torch.models import kimi_vl as kv
    moe = kv.moe

    def no_shared(lp, cfg, x, valid=None, counts=None):
        y, idx = moe(lp, cfg, x, valid, counts)
        return y - kv.swiglu(x, lp["shared_gate_up"], lp["shared_down"]), idx
    monkeypatch.setattr(kv, "moe", no_shared)
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is False


def test_beams_not_by_the_joint_top_k_are_caught(root, monkeypatch):
    """Each row offers the joint selection only its best word: the beams
    kept are not the joint top K (at t = 0 fewer children than beams are
    live, and beams of no path are kept)."""
    from vsrcic_tpu_torch.models import kimi_vl as kv
    cands = kv.topk_candidates

    def best_only(vals, ids, lse, glp, verb_curr, tgt, k):
        ci, cw, g = cands(vals, ids, lse, glp, verb_curr, tgt, k)
        cw = cw.clone()
        cw[:, 1:] = torch.where((verb_curr != -1)[:, None], cw[:, 1:],
                                -torch.inf)
        return ci, cw, g
    monkeypatch.setattr(kv, "topk_candidates", best_only)
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is False
    assert (line["checks"]["beam_gap"]["value"]
            > line["checks"]["beam_gap"]["limit"])


def test_beams_extended_alone_are_caught_by_the_cut(root, monkeypatch):
    """From step 1 each beam offers the joint selection only its best
    child: every kept child is its prefix's best, so only the joint cut
    (`cut_gap`) sees that the kept beams are not the K best."""
    from vsrcic_tpu_torch.models import kimi_vl as kv
    cands = kv.topk_candidates
    calls = [0]
    t_len = layout.cell(CELL, root).config["captioner"]["seq_len"]

    def alone(vals, ids, lse, glp, verb_curr, tgt, k):
        ci, cw, g = cands(vals, ids, lse, glp, verb_curr, tgt, k)
        calls[0] += 1
        if calls[0] % t_len == 1:
            return ci, cw, g
        best = torch.arange(cw.shape[1]) == cw.argmax(1, keepdim=True)
        return (ci, torch.where(best, cw, -torch.inf),
                torch.where(torch.arange(2) == g.argmax(1, keepdim=True), g,
                            -torch.inf))
    monkeypatch.setattr(kv, "topk_candidates", alone)
    rc, line = run_cell(root, CELL, seconds=0.3)
    checks = line["checks"]
    assert rc == 0 and line["correct"] is False
    assert checks["cut_gap"]["value"] > checks["cut_gap"]["limit"]
    assert checks["beam_gap"]["value"] <= checks["beam_gap"]["limit"]


def test_vocab_head_roofline_reads_the_head(root):
    """The word head's share of its least time: calls from the wrapper's
    counter, device time from the operations named `vocab_*`; nothing
    read, nothing raised, on a slice without them."""
    from vsrbench import yardstick as ys
    cell = layout.cell(CELL, root)
    c, tr = tiny_model(root), cell.traffic
    shape = eval_stream.shape_of(cell.config, tr)

    class Slice:
        counters = {"vocab": 40}

        @staticmethod
        def device_ms(prefixes):
            assert prefixes == ("vocab_",)
            return 8.0, 80
    ctx = SimpleNamespace(config=cell.config, traffic=tr, shape=shape,
                          slice=Slice)
    metric = harness.load_metric(cell.metric_file(
        "vocab_head_roofline_pct.vlm"))
    rows = tr["jobs"] * shape["beam"]
    want = 100.0 * 40 * ys.vocab_head_bound_s(
        rows, c["hidden_size"], c["vocab_size"], shape["beam"], 4, 4) / 8e-3
    assert metric.read(ctx) == pytest.approx(want)
    Slice.counters = {"vocab": 0}
    assert metric.read(ctx) is None
