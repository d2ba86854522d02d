"""The port's observability module (`vsrcic_tpu_torch.utils.observability`)
against `vsrcic_tpu.utils.observability`: the same JSONL records save for
their time `t`, the same NaN guard, and a NaN debug switch that makes a NaN
in a backward raise (autograd's anomaly mode in place of jax_debug_nans).
Then the port's span recorder, which the JAX package does not have: parent
links, batch ids, waits, self time, counts on the innermost span, the
bounded buffer, the switch, and record_function ranges under an active
profiler alone."""
import json
import os

import numpy as np
import pytest
import torch

from vsrcic_tpu.utils import observability as jax_obs
from vsrcic_tpu_torch.utils import observability as torch_obs

SCALARS = [("train_loss", 1.5, 0), ("train_loss", np.float32(1.25), 1),
           ("val_cider", torch.tensor(0.5), 1), ("train_loss", 7, 2)]


def records(mod, log_dir):
    log = mod.MetricLogger(str(log_dir), name="t")
    for key, value, step in SCALARS:
        log.add_scalar(key, value, step)
    log.close()
    with open(os.path.join(log_dir, "t.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_records_match_jax(tmp_path):
    got = records(torch_obs, tmp_path / "torch")
    want = records(jax_obs, tmp_path / "jax")
    assert len(got) == len(want) == len(SCALARS)
    for g, w in zip(got, want):
        assert set(g) == set(w) and isinstance(g.pop("t"), float)
        w.pop("t")
        assert g == w
    assert got[1] == {"step": 1, "train_loss": 1.25}


def test_metric_logger_appends(tmp_path):
    records(torch_obs, tmp_path)
    assert len(records(torch_obs, tmp_path)) == 2 * len(SCALARS)


def test_metric_logger_disabled():
    log = torch_obs.MetricLogger(None)
    log.add_scalar("x", 1.0, 0)  # no-op, no crash
    log.close()


@pytest.mark.parametrize("value", [float("nan"), np.inf, -np.inf])
def test_check_finite_raises_as_jax(value):
    assert torch_obs.check_finite("loss", 1.0) == jax_obs.check_finite(
        "loss", 1.0) == 1.0
    for mod in (torch_obs, jax_obs):
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            mod.check_finite("loss", value)


def test_spans_nest_with_parents_batches_and_waits():
    rec = torch_obs.Recorder()
    with rec.span("outer", batch=3) as outer:
        with rec.span("inner", wait=True) as inner:
            pass
        with rec.scope(9):
            with rec.span("same_batch") as same:
                pass
    with rec.scope(9):
        with rec.span("scoped") as scoped:
            with rec.span("own", batch=4) as own:
                pass
    with rec.span("bare") as bare:
        pass
    assert [s.name for s in rec.closed()] == [
        "outer", "inner", "same_batch", "scoped", "own", "bare"]
    assert [s.index for s in rec.closed()] == list(range(6))
    assert (outer.parent, inner.parent, same.parent) == (None, 0, 0)
    assert (scoped.parent, own.parent, bare.parent) == (None, 3, None)
    # a span's batch id: its own, else its parent's, else its scope's
    assert (outer.batch, inner.batch, same.batch) == (3, 3, 3)
    assert (scoped.batch, own.batch, bare.batch) == (9, 4, None)
    assert inner.wait and not outer.wait
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
               for s in (inner, same))


def test_summary_self_time_and_counts(monkeypatch):
    clock = iter(range(0, 10 ** 9, 10 ** 6))     # 1 ms a reading
    monkeypatch.setattr(torch_obs.time, "perf_counter_ns",
                        lambda: next(clock))
    rec = torch_obs.Recorder()
    with rec.span("step"):                      # 0 .. 7 ms
        rec.count("rows", 5)
        with rec.span("wait", wait=True):       # 1 .. 2 ms
            rec.count("bytes", 16)
        rec.count("rows", 2)
        with rec.span("work"):                  # 3 .. 6 ms
            with rec.span("work"):              # 4 .. 5 ms
                rec.count("bytes", 4)
    since = next(clock)                         # 8 ms
    with rec.span("later"):
        pass
    summ = rec.summary()
    assert summ["step"] == {"count": 1, "total_ms": 7.0, "self_ms": 3.0,
                            "wait": False, "counts": {"rows": 7}}
    assert summ["wait"] == {"count": 1, "total_ms": 1.0, "self_ms": 1.0,
                            "wait": True, "counts": {"bytes": 16}}
    # counts land on the innermost open span
    assert summ["work"] == {"count": 2, "total_ms": 4.0, "self_ms": 3.0,
                            "wait": False, "counts": {"bytes": 4}}
    assert list(rec.summary(since_ns=since)) == ["later"]
    line = torch_obs.summary_line(summ, 2, "batch")
    assert line.startswith("spans: host ms a batch over 2")
    assert "step 3.500 (1.500) {rows 3.50}" in line
    assert "wait [wait] 0.500 (0.500) {bytes 8}" in line
    rec.count("nowhere", 1)                     # no span open: dropped
    rec.clear()
    assert rec.summary() == {} and rec.closed() == []


def test_other_threads_count_into_the_shared_span():
    """A thread with no span of its own counts into the innermost open
    shared span of any thread only inside a backward pass of the autograd
    engine (as the engine's CUDA threads do; here the worker runs the
    engine itself); a thread's own open span keeps its counts; other
    threads' counts, and any once the shared span closes, drop."""
    import threading
    rec = torch_obs.Recorder()

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            rec.count(ctx.name, 1)
            return g * 2

    def backward_of(name):
        x = torch.ones(2, requires_grad=True)
        y = Counted.apply(x)
        y.grad_fn.name = name
        torch.autograd.grad(y.sum(), [x])

    def worker(name):
        rec.count("plain", 1)
        backward_of(name)
        with rec.span("own"):
            rec.count("mine", 1)

    def in_thread(name):
        t = threading.Thread(target=worker, args=(name,))
        t.start()
        t.join()
    with rec.span("train.forward"):
        in_thread("lost")
    with rec.span("train.backward", shared=True) as shared:
        with rec.span("inner"):
            in_thread("products")
            rec.count("here", 1)
    in_thread("after")
    summ = rec.summary()
    assert shared.shared and summ["train.backward"]["counts"] == {
        "products": 1}
    assert summ["inner"]["counts"] == {"here": 1}
    assert summ["own"]["counts"] == {"mine": 3}
    assert summ["train.forward"]["counts"] == {}
    assert rec._shared == []


def test_bounded_buffer_counts_what_it_drops():
    rec = torch_obs.Recorder(capacity=4)
    made = []
    for i in range(6):
        with rec.span("s%d" % i) as s:
            made.append(s)
    kept = rec.closed()
    assert [s.name for s in kept] == ["s2", "s3", "s4", "s5"]
    # the newest span dropped started at dropped_until_ns
    assert rec.dropped == 2 and rec.dropped_until_ns == made[1].start_ns
    rec.clear()
    assert rec.dropped == 0 and rec.dropped_until_ns is None


def test_disabled_recorder_records_nothing():
    rec = torch_obs.Recorder()
    rec.enabled = False
    with rec.scope(1):
        with rec.span("a") as s:
            rec.count("n", 1)
    assert s is None and rec.closed() == [] and rec.dropped == 0
    rec.enabled = True
    with rec.span("b"):
        pass
    assert [s.name for s in rec.closed()] == ["b"]


def test_module_functions_use_the_one_recorder():
    rec = torch_obs.RECORDER
    assert rec.enabled
    n = len(rec.closed())
    with torch_obs.span("module.span", batch=2):
        torch_obs.count("k", 3)
    s = rec.closed()[-1]
    assert len(rec.closed()) == n + 1
    assert (s.name, s.batch, s.counts) == ("module.span", 2, {"k": 3})
    assert torch_obs.summary(s.start_ns)["module.span"]["count"] == 1


@pytest.mark.parametrize("active", [False, True])
def test_record_function_only_under_an_active_profiler(active, monkeypatch):
    """Under an active torch.profiler each span is a record_function range
    of its name on the profiler's timeline; with none active no
    record_function is made."""
    from torch.profiler import ProfilerActivity, profile
    made = []
    real = torch_obs.record_function
    monkeypatch.setattr(torch_obs, "record_function",
                        lambda name: made.append(name) or real(name))
    rec = torch_obs.Recorder()

    def work():
        with rec.span("obs.outer"):
            with rec.span("obs.inner", wait=True):
                (torch.arange(16.0).reshape(4, 4) @ torch.ones(4, 4)).sum()

    if not active:
        work()
        assert made == []
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    assert made == ["obs.outer", "obs.inner"]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("obs.")}
    assert set(ranges) == {"obs.outer", "obs.inner"}
    assert (ranges["obs.outer"].start <= ranges["obs.inner"].start
            <= ranges["obs.inner"].end <= ranges["obs.outer"].end)
    assert len(rec.closed()) == 2


def test_no_trace_exporter_left():
    assert not hasattr(torch_obs, "trace")
    assert "VSRCIC_TRACE_DIR" not in torch_obs.__doc__


def test_nan_debug_raises_in_a_backward():
    def backward_of_sqrt_at_minus_one():
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        torch.sqrt(x).sum().backward()
        return x.grad

    assert torch.isnan(backward_of_sqrt_at_minus_one()[0])
    torch_obs.enable_nan_debug(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            backward_of_sqrt_at_minus_one()
    finally:
        torch_obs.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(backward_of_sqrt_at_minus_one()[0])
