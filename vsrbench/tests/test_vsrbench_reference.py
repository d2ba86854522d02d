"""The plain reference agrees with the program's strict path at tiny sizes
on the CPU (the program's kernels run their plain versions here)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vsrbench import harness, layout
from vsrbench.drivers import eval_stream, xe_train
from vsrbench.reference import captioner as rc
from vsrbench.reference import plan as rp
from vsrbench.reference import planner as rpl
from vsrbench.tests.tiny import tiny_root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def world(root):
    cell = layout.cell("vsr-coco.stream-b512", root)
    w = eval_stream.make_weights(cell.config, 21, CPU)
    return cell, w


def test_step_matches_program(world):
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   CaptionerState, _step_core)
    cell, w = world
    c = cell.config["captioner"]
    g = torch.Generator().manual_seed(3)
    b, m = 5, 4
    state = tuple(torch.randn((b, c["rnn_size"]), generator=g)
                  for _ in range(4))
    det = torch.randn((b, m, c["det_feat_size"]), generator=g)
    det[:, -1] = 0
    idesc = torch.randn((b, c["det_feat_size"]), generator=g)
    it = torch.randint(0, c["vocab_size"], (b,), generator=g)
    proj = det @ w["captioner"]["att_va"]["weight"].T
    mask = (det.sum(-1) != 0).float()
    (wlp, glp), new = _step_core(w["captioner"], CaptionerConfig(**c),
                                 CaptionerState(*state, None), it, det, proj,
                                 mask, idesc)
    logits, glp_r, new_r = rc.step(w["captioner"], c, state, it, det, proj,
                                   mask, idesc)
    torch.testing.assert_close(torch.log_softmax(logits, -1), wlp,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(glp_r, glp, rtol=1e-5, atol=1e-6)
    for a, r in zip(new, new_r):
        torch.testing.assert_close(r, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fast", [False, True], ids=["strict", "plain-ops"])
def test_stream_batch_judged_sound(root, world, fast):
    """One streamed batch through the pipeline, judged: the plan exact,
    every gap at round-off."""
    cell, w = world
    cfg = dict(cell.config, program=dict(cell.config["program"],
                                         use_fused_attention=fast,
                                         use_vocab_topk=fast))
    pipe = eval_stream.build_program(cfg, w, CPU)
    batch = eval_stream.make_batch(cfg, cell.traffic, 21, 0, CPU)
    captured = {"gen": [], "sink": [], "plan": [], "beam": []}
    eval_stream.instrument(pipe, harness.Spans(), captured)
    words = list(pipe.run_stream([batch.stream]))
    out = eval_stream.collect(captured, [(0.0, x) for x in words])[0]
    got = eval_stream.judge_batch(cfg, cell.traffic, w, batch, out,
                                  cell.limits)
    assert got["plan_exact"] == 0 and got["failed"] == 0
    assert got["planner_gap"] < 1e-5
    assert got["sinkhorn_gap"] < 1e-6
    assert got["beam_gap"] < 1e-5
    assert got["search_judged"] > 0 and got["search_gap"] < 1e-5


@pytest.mark.parametrize("fast", [False, True], ids=["strict", "plain-ops"])
def test_beam_search_matches_program(world, fast):
    """The reference's own beam search keeps the program's beams, rank by
    rank, on every job where it meets no near tie; verb rows included."""
    cell, w = world
    cfg = dict(cell.config, program=dict(cell.config["program"],
                                         use_fused_attention=fast,
                                         use_vocab_topk=fast))
    c, plan = cfg["captioner"], cfg["plan"]
    cap = eval_stream.build_program(cfg, w, CPU).captioner
    g = torch.Generator().manual_seed(5)
    jobs, length = 40, plan["fixed_len"]
    det = torch.randn((jobs, plan["detections"], c["det_feat_size"]),
                      generator=g)
    recons = torch.randn((jobs, length, plan["regions"],
                          c["det_feat_size"]), generator=g)
    recons[:, :, -1] = 0
    recons[:, 6:] = 0
    verbs = torch.randint(1, plan["n_verbs"] + 1, (jobs,), generator=g)
    verb_list = torch.full((jobs, length), -1, dtype=torch.long)
    verb_list[torch.arange(jobs), torch.arange(jobs) % 4] = verbs
    res = cap.beam_search_v(det, recons, verb_list,
                            eos_word=plan["eos_word"], beam_size=5)
    words, gates, scores, margin = rc.beam_search(
        w["captioner"], c, det, recons, verb_list,
        torch.from_numpy(w["tense_ids"]), 5)
    sure = margin >= cell.traffic["search_tie"]
    assert sure.sum() >= jobs // 5
    assert torch.equal(res.words[sure], words[sure])
    assert torch.equal(res.gates[sure], gates[sure])
    torch.testing.assert_close(res.scores[sure], scores[sure], rtol=1e-5,
                               atol=1e-5)


def test_planner_matches_full_buffer_decode(world):
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, ssp_generate
    cell, w = world
    p = cell.config["planner"]
    sr = torch.tensor([[3, 7, 25, 0, 0, 0, 0, 0, 0, 0],
                       [5, 9, 12, 25, 0, 0, 0, 0, 0, 0],
                       [0] * 10])
    verbs = torch.tensor([4.0, 17.0, 0.0])
    cfg = SSPConfig(**{k: v for k, v in p.items()
                       if k in SSPConfig.__dataclass_fields__})
    pred, lps = ssp_generate(w["planner"], cfg, verbs[:, None], sr,
                             mode="not-normal")
    got = rpl.judge_planner(w["planner"], p, verbs, sr, pred, lps)
    assert float(got["selection"].max()) < 1e-5
    assert float(got["record"].max()) < 1e-5
    bad = pred.clone()
    bad[0, 0], bad[0, 1] = pred[0, 1], pred[0, 0]
    assert float(rpl.judge_planner(w["planner"], p, verbs, sr, bad,
                                   lps)["selection"].max()) > 1e-3


def test_sinkhorn_net_matches_program(world):
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  sinkhorn_net_apply)
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize_plain
    cell, w = world
    s = cell.config["sinkhorn"]
    rows = torch.randn((6, s["n"], s["txt_dim"] + s["vis_dim"]
                        + s["pos_dim"]), generator=torch.Generator()
                       .manual_seed(4))
    want = sinkhorn_net_apply(w["sinkhorn"], SinkhornConfig(**s), rows,
                              normalize=sinkhorn_normalize_plain)
    torch.testing.assert_close(rpl.sinkhorn_net(w["sinkhorn"], s, rows),
                               want, rtol=1e-5, atol=1e-6)


def test_recons_matches_program():
    from vsrcic_tpu_torch.pipelines.eval_pipeline import EvalPipeline
    g = torch.Generator().manual_seed(5)
    seqs = torch.randn((3, 6, 2, 4), generator=g)
    seqs[0, 2] = 0
    seqs[2] = 0
    rank_idx = np.array([[1, 2, 0, 0, 0, 0], [5, 4, 3, 0, 0, 0],
                         [0, 1, 0, 0, 0, 0]])
    rank_valid = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 0, 0, 0],
                           [1, 1, 0, 0, 0, 0]], bool)
    want = EvalPipeline._build_recons_impl(
        seqs, torch.from_numpy(rank_idx), torch.from_numpy(rank_valid))
    assert torch.equal(rp.recons(seqs, rank_idx, rank_valid), want)


def test_rank_merge_matches_program():
    from vsrcic_tpu_torch.utils.rank_merge import verb_rank_merge
    rng = np.random.default_rng(6)
    for _ in range(200):
        la = list(rng.choice(12, rng.integers(0, 6), replace=False))
        lb = list(rng.choice(12, rng.integers(0, 6), replace=False))
        assert rp.rank_merge(la, lb) == verb_rank_merge(la, lb)


def test_xe_matches_program(root):
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.train.captioner import xe_loss_fn
    from vsrcic_tpu_torch.train.common import adam, value_and_grad
    cell = layout.cell("captioner-coco.xe-b1024", root)
    cfg, tr = cell.config, cell.traffic
    p0 = xe_train.make_weights(cfg, 8, CPU)
    det, caps, ids, gates = xe_train.make_batch(cfg, tr, 8, 0, CPU)
    (loss, (lc, lg)), grads = value_and_grad(
        xe_loss_fn, p0, CaptionerConfig(**cfg["captioner"]), det, caps, ids,
        gates, has_aux=True)
    lw_r, lg_r, grads_r = rc.xe_grads(p0, cfg["captioner"], det, caps, ids,
                                      gates, 3)
    assert lw_r == pytest.approx(float(lc), rel=1e-5)
    assert lg_r == pytest.approx(float(lg), rel=1e-5)
    flat = xe_train.flat(grads)
    for k, gr in grads_r.items():
        torch.testing.assert_close(gr, flat[k], rtol=1e-4, atol=1e-6)
    tx = adam(cfg["optim"]["lr"])
    upd, _ = tx.update(grads, tx.init(p0))
    new_r, _, _ = rc.adam_step(
        xe_train.flat(p0), flat, {k: torch.zeros_like(v) for k, v in
                                  flat.items()},
        {k: torch.zeros_like(v) for k, v in flat.items()}, 1,
        cfg["optim"]["lr"])
    for k, u in xe_train.flat(upd).items():
        torch.testing.assert_close(new_r[k] - xe_train.flat(p0)[k], u,
                                   rtol=1e-4, atol=1e-9)


def test_judge_beams_catches_an_altered_word(world):
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    cell, w = world
    c = cell.config["captioner"]
    cap = ControllableCaptioner(CaptionerConfig(**c), params=w["captioner"],
                                verb_2_vob_all=w["tense_map"], device="cpu")
    g = torch.Generator().manual_seed(9)
    det = torch.randn((3, 5, c["det_feat_size"]), generator=g)
    groups = torch.randn((3, 4, 2, c["det_feat_size"]), generator=g)
    vl = torch.tensor([[-1, 7, -1, -1], [3, -1, -1, -1], [-1] * 4])
    res = cap.beam_search_v(det, groups, vl, eos_word=3, beam_size=3)
    served = {"words": res.words, "gates": res.gates,
              "word_logps": res.word_logps, "gate_logps": res.gate_logps,
              "scores": res.scores}
    tense = torch.from_numpy(w["tense_ids"])
    ok = rc.judge_beams(w["captioner"], c, det, groups, vl, tense, served, 3)
    assert max(float(ok[k].max()) for k in ("selection", "record",
                                            "score")) < 1e-5
    bad = dict(served, words=served["words"].clone())
    bad["words"][2, 0, 2] = (bad["words"][2, 0, 2] + 7) % c["vocab_size"]
    worse = rc.judge_beams(w["captioner"], c, det, groups, vl, tense, bad, 3)
    assert float(worse["selection"][2]) > 1e-3 or \
        float(worse["score"][2]) > 1e-3
