"""The recorder's spans inside the port's eval stream and trainers, on the
CPU: each batch of `EvalPipeline.run_stream` carries its spans in the
schedule's order under its stream index, and an XE or SCST step its spans
in the order forward, backward, Adam, read-back; with the recorder off the
words and losses are the same."""
import numpy as np
import pytest
import torch

from vsrcic_tpu_torch.pipelines import CaptionJob
from vsrcic_tpu_torch.train import captioner as ttrain
from vsrcic_tpu_torch.utils import observability as obs

import torch_parity as tp

# one batch's spans on the main path, in the order they open
PLAN_DISPATCH = ["eval.plan_dispatch", "eval.groups", "eval.sinkhorn",
                 "eval.planner"]
SEQ_LEN = tp.T      # the pipeline world's caption length: its beam steps
BATCH = (["eval.plan_finish", "eval.plan_wait", "eval.hungarian",
          "eval.assemble", "eval.recons", "eval.beam_dispatch",
          "beam.statics"] + ["beam.step"] * SEQ_LEN
         + ["eval.words_copy", "eval.words_wait"])


@pytest.fixture
def recorder():
    """The module's recorder, emptied, on; left on and emptied."""
    obs.clear()
    obs.RECORDER.enabled = True
    yield obs.RECORDER
    obs.RECORDER.enabled = True
    obs.clear()


@pytest.fixture(scope="module")
def stream_world():
    params, _, batches, _ = tp.load_golden_pipeline()
    fields = batches[0]      # verb groups and ambiguous pairs
    stream = [(fields["detections"], tp.jobs_from(fields, CaptionJob))] * 3
    return tp.torch_pipeline(params), stream


def test_run_stream_spans_by_batch(recorder, stream_world):
    pipe, stream = stream_world
    words = list(pipe.run_stream(iter(stream)))
    spans = recorder.closed()
    assert all(s.batch in (0, 1, 2) for s in spans), spans
    by_batch = {k: [s.name for s in spans if s.batch == k] for k in range(3)}
    for k in range(3):
        assert by_batch[k] == PLAN_DISPATCH + BATCH, (k, by_batch[k])
    # one batch ahead: batch k+1's plan is dispatched before batch k's beam
    first = {}
    for s in spans:
        first.setdefault((s.name, s.batch), s.index)
    for k in range(2):
        assert (first["eval.recons", k] < first["eval.plan_dispatch", k + 1]
                < first["eval.beam_dispatch", k])
        assert first["eval.beam_dispatch", k + 1] > first[
            "eval.words_copy", k]
    # nesting: plan_dispatch's parts and the beam under their calls
    by_index = {s.index: s for s in spans}
    for s in spans:
        parent = by_index.get(s.parent)
        want = {"eval.groups": "eval.plan_dispatch",
                "eval.sinkhorn": "eval.plan_dispatch",
                "eval.planner": "eval.plan_dispatch",
                "eval.plan_wait": "eval.plan_finish",
                "eval.hungarian": "eval.plan_finish",
                "eval.assemble": "eval.plan_finish",
                "beam.statics": "eval.beam_dispatch",
                "beam.step": "eval.beam_dispatch"}.get(s.name)
        assert (parent.name if parent else None) == want, s
    assert [s.wait for s in spans if s.wait] and {
        s.name for s in spans if s.wait} == {"eval.plan_wait",
                                            "eval.words_wait"}
    # counts from host shapes
    n_jobs = len(stream[0][1])
    plan = [s for s in spans if s.name == "eval.plan_dispatch"]
    assert all(s.counts["jobs"] == n_jobs and s.counts["groups"] > 0
               and s.counts["pairs"] > 0 for s in plan)
    assert all(s.counts["planner_steps"] >= 2
               for s in spans if s.name == "eval.planner")
    assert all(s.counts["h2d_bytes"] > 0
               for s in spans if s.name == "eval.sinkhorn")
    # on the CPU nothing is copied back, so nothing is counted
    assert not any("d2h_bytes" in s.counts for s in spans)
    assert [s.counts["rows"] for s in spans
            if s.name == "eval.beam_dispatch"] == [n_jobs * pipe.beam_size] * 3
    # one beam.step a step, t = 0 too; their order gives the step
    assert [s.counts for s in spans if s.name == "beam.step"
            and s.batch == 1] == [{}] * SEQ_LEN

    recorder.enabled = False
    quiet = list(pipe.run_stream(iter(stream)))
    assert len(recorder.closed()) == len(spans)
    assert len(quiet) == len(words) == 3
    for a, b in zip(quiet, words):
        np.testing.assert_array_equal(a, b)


def xe_trainer():
    params, g = tp.load_golden_train()
    batch = [g["xe/" + k] for k in ("detections", "captions", "ids",
                                    "gates")]
    return ttrain.CaptionerXETrainer(tp.train_cfg("torch"), params,
                                     lr=float(g["lr"]), device="cpu"), batch


def test_xe_step_spans_in_order(recorder):
    tr, batch = xe_trainer()
    losses = [tr.step(*batch) for _ in range(2)]
    spans = recorder.closed()
    assert [(s.name, s.batch) for s in spans] == [
        (n, k) for k in (0, 1) for n in ("xe.step", "train.forward",
                                         "train.backward", "train.adam",
                                         "train.readback")]
    steps = [s for s in spans if s.name == "xe.step"]
    for s in spans:
        if s.name != "xe.step":
            assert s.parent in [t.index for t in steps]
    assert [s.name for s in spans if s.wait] == ["train.readback"] * 2

    recorder.enabled = False
    tr2, _ = xe_trainer()
    assert [tr2.step(*batch) for _ in range(2)] == losses
    assert len(recorder.closed()) == len(spans)


def test_scst_step_spans_in_order(recorder):
    params, _ = tp.load_golden_train()
    tf, cider = tp.text_world("torch")
    det, grp, gts = tp.scst_batch()
    tr = ttrain.CaptionerSCSTTrainer(tp.train_cfg("torch"), params, tf,
                                     cider, device="cpu")
    tr.step(det, grp, gts, torch.Generator().manual_seed(0))
    names = [(s.name, s.batch) for s in recorder.closed()]
    assert names == [(n, 0) for n in (
        "scst.step", "scst.decode", "scst.reward", "train.forward",
        "train.backward", "train.adam", "train.readback")]
