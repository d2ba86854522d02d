"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; a token or an answer
altered where it is produced; beams kept or ranked otherwise than by the
joint top K; an update skipped once set-up is over. (Neither cell runs across cards, so no
exchange between them can be left out.)"""
from __future__ import annotations

import json

import pytest

from vsrbench.tests.tiny import run_cell, tiny_root

EVAL, XE = "vsr-coco.stream-b512", "captioner-coco.xe-b1024"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def assert_not_correct(root, cell):
    rc, line = run_cell(root, cell, seconds=0.3)
    assert rc == 0 and line["correct"] is False
    return line


@pytest.mark.parametrize("fused", [False, True], ids=["step", "fused-step"])
def test_eval_step_state_unchanged(tmp_path, monkeypatch, fused):
    """The step returns its state unchanged, on the cell's path and on the
    fused attention path."""
    from vsrcic_tpu_torch.models import captioner as cap
    root = tiny_root(tmp_path)
    path = root / "vsrbench" / "configs" / "vsr-coco.json"
    cfg = json.loads(path.read_text())
    cfg["program"]["use_fused_attention"] = fused
    path.write_text(json.dumps(cfg))
    name = "_step_core_fused" if fused else "_step_core"
    step = getattr(cap, name)

    def stale(params, cfg, state, *a, **kw):
        out, _ = step(params, cfg, state, *a, **kw)
        return out, (state.h1, state.c1, state.h2, state.c2)
    monkeypatch.setattr(cap, name, stale)
    line = assert_not_correct(root, EVAL)
    assert line["checks"]["beam_gap"]["value"] > \
        line["checks"]["beam_gap"]["limit"]


def test_eval_half_the_jobs_left_out(root, monkeypatch):
    from vsrcic_tpu_torch.pipelines.eval_pipeline import EvalPipeline
    dispatch = EvalPipeline._dispatch_beam

    def half(self, dets, recons, verb_lists, n_jobs):
        words = dispatch(self, dets, recons, verb_lists, n_jobs).clone()
        words[n_jobs // 2:] = 0
        return words
    monkeypatch.setattr(EvalPipeline, "_dispatch_beam", half)
    line = assert_not_correct(root, EVAL)
    assert line["checks"]["yield_exact"]["value"] > 0


def test_eval_token_altered(root, monkeypatch):
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    beam = ControllableCaptioner.beam_search_v

    def altered(self, *a, **kw):
        res = beam(self, *a, **kw)
        words = res.words.clone()
        words[:, :, 2] = (words[:, :, 2] + 1) % self.cfg.vocab_size
        return res._replace(words=words)
    monkeypatch.setattr(ControllableCaptioner, "beam_search_v", altered)
    line = assert_not_correct(root, EVAL)
    assert line["checks"]["beam_gap"]["value"] > \
        line["checks"]["beam_gap"]["limit"]


def test_eval_beams_extended_alone(root, monkeypatch):
    """Each beam slot extended by its own best child instead of the joint
    top K over every slot's children (beam 0's K best children at t = 0,
    the beams ranked best first at the end): every served choice is among
    its prefix's K best, so only the reference's own search sees it."""
    import torch
    from vsrcic_tpu_torch.decode.beam import BeamResult
    from vsrcic_tpu_torch.models import api

    def alone(step_fn, state, batch, beam_size, seq_len, eos_word,
              vocab_size, eos_gate=-1):
        k = beam_size
        rows = torch.arange(batch * k)
        zeros = torch.zeros((batch * k,), dtype=torch.long)
        (ids, wlp, g), state = step_fn(state, zeros, zeros, True)
        c = ids.shape[1]
        joint = (wlp[:, :, None] + g[:, None, :]).reshape(batch, k, 2 * c)
        seq, pick = joint[:, 0].topk(k, -1)
        first = (rows // k) * k
        word = ids[first].reshape(batch, k, c).gather(
            2, (pick // 2)[..., None])[..., 0]
        gate = pick % 2
        wl = [wlp[first].reshape(batch, k, c).gather(
            2, (pick // 2)[..., None])[..., 0]]
        gl = [g[first].reshape(batch, k, 2).gather(2, gate[..., None])[..., 0]]
        state = type(state)(*(x[first] for x in state))
        words, gates, alive = [word], [gate], (word != eos_word).float()
        for _ in range(1, seq_len):
            (ids, wlp, g), state = step_fn(state, word.reshape(-1),
                                           gate.reshape(-1), False)
            joint = (wlp[:, :, None] + g[:, None, :]).reshape(batch * k, -1)
            best, at = joint.max(-1)
            word = ids.gather(1, (at // 2)[:, None])[:, 0].reshape(batch, k)
            gate = (at % 2).reshape(batch, k)
            seq = seq + best.reshape(batch, k)
            wl.append(wlp.gather(1, (at // 2)[:, None]).reshape(batch, k)
                      * alive)
            gl.append(g.gather(1, (at % 2)[:, None]).reshape(batch, k))
            alive = alive * (word != eos_word).float()
            words.append(word)
            gates.append(gate)
        order = seq.argsort(1, descending=True)
        out = [torch.stack(x, 2).gather(1, order[..., None].expand(
            -1, -1, seq_len)) for x in (words, gates, wl, gl)]
        return BeamResult(*out, seq.gather(1, order))
    monkeypatch.setattr(api, "beam_search_joint_candidates", alone)
    line = assert_not_correct(root, EVAL)
    checks = line["checks"]
    assert checks["search_gap"]["value"] > checks["search_gap"]["limit"]
    assert checks["beam_gap"]["value"] <= checks["beam_gap"]["limit"]


def test_eval_beams_not_ranked(root, monkeypatch):
    """The beams served worst first: the yielded caption is not the best."""
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    beam = ControllableCaptioner.beam_search_v

    def reversed_(self, *a, **kw):
        return type(beam(self, *a, **kw))(
            *(x.flip(1) for x in beam(self, *a, **kw)))
    monkeypatch.setattr(ControllableCaptioner, "beam_search_v", reversed_)
    line = assert_not_correct(root, EVAL)
    assert line["checks"]["beam_gap"]["value"] > \
        line["checks"]["beam_gap"]["limit"]


def test_eval_planner_token_altered(root, monkeypatch):
    from vsrcic_tpu_torch.pipelines import eval_pipeline as ep
    gen = ep.ssp_generate_fast

    def swapped(*a, **kw):
        pred, lps = gen(*a, **kw)
        pred = pred.clone()
        pred[:, [0, 1]] = pred[:, [1, 0]]
        return pred, lps
    monkeypatch.setattr(ep, "ssp_generate_fast", swapped)
    line = assert_not_correct(root, EVAL)
    assert line["checks"]["planner_gap"]["value"] > \
        line["checks"]["planner_gap"]["limit"]


def test_xe_state_unchanged(root, monkeypatch):
    from vsrcic_tpu_torch.train import captioner as tc
    monkeypatch.setattr(tc, "apply_grads",
                        lambda tx, state, grads, mesh=None: state)
    line = assert_not_correct(root, XE)
    assert line["checks"]["update_gap"]["value"] >= 0.99


def test_xe_update_skipped_after_setup(root, monkeypatch):
    """Steps after set-up's return their state unchanged: only the step
    after the window sees it."""
    from vsrcic_tpu_torch.train import captioner as tc
    apply, calls = tc.apply_grads, [0]

    def skip_later(tx, state, grads, mesh=None):
        calls[0] += 1
        return apply(tx, state, grads, mesh) if calls[0] <= 3 else state
    monkeypatch.setattr(tc, "apply_grads", skip_later)
    line = assert_not_correct(root, XE)
    assert line["checks"]["update_gap"]["value"] >= 0.99


def test_xe_half_the_batch(root, monkeypatch):
    from vsrcic_tpu_torch.train.captioner import CaptionerXETrainer
    batch = CaptionerXETrainer._batch

    def half(self, *arrays):
        return tuple(x[: x.shape[0] // 2] for x in batch(self, *arrays))
    monkeypatch.setattr(CaptionerXETrainer, "_batch", half)
    line = assert_not_correct(root, XE)
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_xe_loss_altered(root, monkeypatch):
    from vsrcic_tpu_torch.train.captioner import CaptionerXETrainer
    step = CaptionerXETrainer.step

    def altered(self, *a):
        loss, lc, lg = step(self, *a)
        return loss, lc * 1.01, lg
    monkeypatch.setattr(CaptionerXETrainer, "step", altered)
    line = assert_not_correct(root, XE)
    assert line["checks"]["loss_gap"]["value"] > \
        line["checks"]["loss_gap"]["limit"]
