"""The readers of the program's spans on made-up recorders and slices: the
two plan metrics over the window, the profiler's clock found from the unit
spans at a known offset, idle given to the innermost span, and nothing read
where the recorder dropped spans or the program has none."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from vsrbench import harness, program_spans as ps
from vsrbench.harness import UNIT_SPAN
from vsrbench.tests.tiny import REPO
from vsrcic_tpu_torch.utils import observability as obs

BASE = 1000.0           # perf_counter seconds at the slice's first unit
OFF = -987654321.5      # the profiler's clock less perf_counter's, in us


def metric(name):
    return harness.load_metric(REPO / "vsrbench" / "metrics"
                               / (name + ".py")).read


class Clock:
    """perf_counter_ns for the recorder, set by the test."""
    ns = 0

    def __call__(self):
        return self.ns


def add(rec, name, t0_ms, t1_ms, wait=False, inner=()):
    """A span from BASE + t0 ms to BASE + t1 ms, opened and closed through
    the recorder on a set clock, with the spans `inner` (tuples of add's
    arguments) inside it."""
    clock = obs.time.perf_counter_ns
    clock.ns = round((BASE + t0_ms / 1e3) * 1e9)
    with rec.span(name, wait=wait) as s:
        for args in inner:
            add(rec, *args)
        clock.ns = round((BASE + t1_ms / 1e3) * 1e9)
    return s


def prof_us(t_ms):
    return (BASE + t_ms / 1e3) * 1e6 + OFF


@pytest.fixture
def rec(monkeypatch):
    r = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", r)
    monkeypatch.setattr(obs.time, "perf_counter_ns", Clock())
    return r


def xe_world(rec):
    """Three units of 10 ms 2 ms apart, the first the slice's warm one;
    in each an xe.step with forward, backward, Adam and the read-back, and
    device work that leaves 0.5 + 0.5 ms idle under the forward, 0.5 + 0.5
    under Adam, 0.3 under the read-back, 0.5 + 0.5 in xe.step itself and
    2 ms between units."""
    units = [(12.0 * u, 12.0 * u + 10.0) for u in range(3)]
    kernels = []
    for lo, _ in units:
        add(rec, "xe.step", lo, lo + 10.0, inner=(
            ("train.forward", lo + 0.5, lo + 3.0),
            ("train.backward", lo + 3.0, lo + 6.0),
            ("train.adam", lo + 6.0, lo + 8.0),
            ("train.readback", lo + 8.0, lo + 9.5, True)))
        for a, b in ((1.0, 2.5), (3.0, 6.0), (6.5, 7.5), (8.0, 9.2)):
            kernels.append(("k", prof_us(lo + a), prof_us(lo + b)))
    window = (prof_us(units[1][0]), prof_us(units[2][1]))
    sl = SimpleNamespace(
        window_us=window,
        kernels=[(n, max(s, window[0]), min(e, window[1]))
                 for n, s, e in kernels if e > window[0] and s < window[1]],
        host=[(UNIT_SPAN, prof_us(a), prof_us(b)) for a, b in units])
    # the harness's own units: the window's (earlier) and the slice's
    items = [(UNIT_SPAN, BASE - 5.0 + i, BASE - 4.5 + i) for i in range(3)]
    items += [(UNIT_SPAN, BASE + a / 1e3, BASE + b / 1e3) for a, b in units]
    return SimpleNamespace(slice=sl, spans=SimpleNamespace(items=items),
                           window=(BASE - 5.0, BASE - 2.0), units=3)


def test_clock_offset_from_the_unit_spans(rec):
    ctx = xe_world(rec)
    assert ps.clock_offset_us(ctx) == pytest.approx(OFF, abs=1e-3)


def test_idle_goes_to_the_innermost_span(rec, capsys):
    ctx = xe_world(rec)
    split, units = ps.idle_by_span(ctx)
    assert units == 2
    by_name = {}
    for s, us in split.items():
        key = None if s is None else s.name
        by_name[key] = by_name.get(key, 0.0) + us / 1e3
    assert by_name == pytest.approx({
        "train.forward": 2.0, "train.adam": 2.0, "train.readback": 0.6,
        "xe.step": 2.0, None: 2.0}, abs=1e-6)
    # not the read-back (a wait), not the gap between steps
    assert metric("host_idle_ms.xe")(ctx) == pytest.approx(3.0, abs=1e-6)
    assert metric("host_idle_ms.eval")(ctx) == pytest.approx(3.0, abs=1e-6)
    err = capsys.readouterr().err
    assert "train.forward 1.000" in err and "train.readback [wait] 0.300" \
        in err and "outside the program's spans 1.000" in err
    assert "76.7% of 4.300 ms a unit under a program span" in err


def test_host_idle_under_a_root_only(rec):
    ctx = xe_world(rec)
    lo = 12.0
    add(rec, "scst.step", lo + 10.2, lo + 11.8,             # between steps
        inner=(("scst.reward", lo + 10.4, lo + 11.6),))
    got = metric("host_idle_ms.xe")(ctx)
    assert got == pytest.approx(3.0, abs=1e-6)
    # any host span counts for the eval reader: 1.6 ms more over 2 units
    assert metric("host_idle_ms.eval")(ctx) == pytest.approx(3.8, abs=1e-6)


def test_idle_readers_read_nothing_without_their_inputs(rec, monkeypatch):
    ctx = xe_world(rec)
    rec.dropped, rec.dropped_until_ns = 1, round(BASE * 1e9)
    assert ps.idle_by_span(ctx) is None
    assert metric("host_idle_ms.xe")(ctx) is None
    rec.dropped_until_ns = round((BASE - 1.0) * 1e9)    # before the slice
    assert metric("host_idle_ms.xe")(ctx) == pytest.approx(3.0, abs=1e-6)
    no_device = SimpleNamespace(**vars(ctx))
    no_device.slice = SimpleNamespace(**dict(vars(ctx.slice), kernels=[]))
    assert metric("host_idle_ms.xe")(no_device) is None
    monkeypatch.delattr(obs, "RECORDER")    # a program without the recorder
    assert metric("host_idle_ms.xe")(ctx) is None
    assert metric("host_idle_ms.eval")(ctx) is None


def eval_world(rec):
    """Two batches in the window, 10 ms apart: plan_dispatch 2 ms,
    plan_finish 5 ms of which the wait 3 ms, recons 1 ms; a third batch's
    spans past the window's end."""
    for k in range(3):
        lo = 10.0 * k
        add(rec, "eval.plan_dispatch", lo, lo + 2.0)
        add(rec, "eval.plan_finish", lo + 2.0, lo + 7.0, inner=(
            ("eval.plan_wait", lo + 2.5, lo + 5.5, True),
            ("eval.hungarian", lo + 5.5, lo + 6.0)))
        add(rec, "eval.recons", lo + 7.0, lo + 8.0)
        add(rec, "eval.words_wait", lo + 8.5, lo + 9.5, True)
    return SimpleNamespace(window=(BASE, BASE + 0.0195), units=2)


def test_plan_metrics_over_the_window(rec):
    ctx = eval_world(rec)
    assert metric("plan_wait_ms.eval")(ctx) == pytest.approx(3.0)
    # 2 + 5 + 1 less the 3 ms wait, a batch
    assert metric("plan_work_ms.eval")(ctx) == pytest.approx(5.0)


def test_plan_metrics_read_nothing_without_their_inputs(rec, monkeypatch):
    ctx = eval_world(rec)
    rec.dropped, rec.dropped_until_ns = 3, round((BASE + 0.001) * 1e9)
    assert metric("plan_wait_ms.eval")(ctx) is None
    assert metric("plan_work_ms.eval")(ctx) is None
    rec.dropped_until_ns = round((BASE - 0.001) * 1e9)
    assert metric("plan_work_ms.eval")(ctx) == pytest.approx(5.0)
    assert metric("plan_work_ms.eval")(SimpleNamespace(
        window=ctx.window, units=0)) is None
    monkeypatch.delattr(obs, "RECORDER")
    assert metric("plan_wait_ms.eval")(ctx) is None
