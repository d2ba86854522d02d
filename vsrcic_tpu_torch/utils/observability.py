"""Spans and counts, metric logging and NaN guards (SURVEY.md §5 aux
subsystems).

Counterpart of `vsrcic_tpu/utils/observability.py`, with torch in place of
jax:

  * `Recorder` and the module's one recorder `RECORDER` (`span`, `scope`,
    `count`, `open_counts`, `summary`, `clear`): named host spans on the
    `time.perf_counter_ns()` clock, each with its parent, an optional batch
    id, a `wait` flag (the host only blocks on the device) and counts, kept
    in a bounded buffer in memory. On by default; `RECORDER.enabled = False`
    records nothing. While a `torch.profiler` is active each span also opens
    a `record_function` range of its name, so the spans stand on the
    profiler's timeline beside the kernels. No span or count reads a device
    tensor: recording adds no synchronisation.
  * `MetricLogger` — structured scalar journal (JSONL, one
    ``{"t", "step", key}`` record per scalar) + optional TensorBoard event
    writing when `tensorboardX`/`tensorboard` is present, same scalar names
    as the reference ('train_loss', ...). The journal needs neither.
  * `check_finite` — host-side NaN/Inf guard mirroring the reference's
    tripwire, raising instead of dropping into pdb; `enable_nan_debug()`
    turns on autograd's anomaly mode, which raises where a backward
    function returns NaN.

The spans the program opens (README.md lists what each covers): the eval
stream's `eval.*` (batch id: the stream's index of the batch) with the
facade's `beam.statics` and `beam.step`, the Kimi-VL decoder's
`vlm.prefill`, `vlm.attn`, `vlm.moe`, `vlm.route`, `vlm.cache` and
`vlm.head` (`models/kimi_vl.py`), and beside them the Kimi-Linear
decoder's `vlm.kda` (`models/kimi_linear.py`); the trainers' `xe.step` and
`scst.step` (batch id: the train state's step) with `train.forward`,
`train.backward`, `train.adam`, `train.readback`, `scst.decode` and
`scst.reward`; `ops.build` around each build or load of a native library.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self.log_dir = log_dir
        self.name = name
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, name + ".jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self._tb = SummaryWriter(log_dir)
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def add_scalar(self, key: str, value, iteration: int):
        value = float(value)
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "step": iteration, key: value}) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(key, value, iteration)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def check_finite(name: str, value) -> float:
    """Raise on NaN/Inf loss (reference pdb tripwire, sort_model.py:101)."""
    v = float(value)
    if not np.isfinite(v):
        raise FloatingPointError("non-finite %s: %r" % (name, v))
    return v


def enable_nan_debug(enable: bool = True):
    import torch
    torch.autograd.set_detect_anomaly(enable)


# ---------------------------------------------------------------------------
# spans and counts
# ---------------------------------------------------------------------------

class Span:
    """One recorded span: `index` (its place in the recorder's sequence),
    `name`, `start_ns` and `end_ns` on the perf_counter_ns clock (`end_ns`
    None while open), `parent` (the index of the span open around it on
    its thread, or None), `batch`, `wait` and `counts` ({name: number}).
    `Recorder.span` returns one not yet open; it is its own context
    manager."""
    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "batch",
                 "wait", "counts", "shared", "_rec", "_rf")

    def __init__(self, rec, name, batch, wait, shared=False):
        self._rec = rec
        self.name = name
        self.batch = batch
        self.wait = wait
        self.shared = shared
        self.end_ns = None
        self.counts = {}

    def __enter__(self):
        rec = self._rec
        local = rec._local
        stack = local.stack
        if stack:
            parent = stack[-1]
            self.parent = parent.index
            if self.batch is None:
                self.batch = parent.batch
        else:
            self.parent = None
            if self.batch is None:
                self.batch = local.batch
        self.index = next(rec._count)
        self.start_ns = time.perf_counter_ns()
        spans = rec.spans
        if len(spans) == spans.maxlen:
            rec.dropped += 1
            rec.dropped_until_ns = spans[0].start_ns
        spans.append(self)
        stack.append(self)
        if self.shared:
            rec._shared.append(self)
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._rec._local.stack.pop()
        if self.shared:
            self._rec._shared.remove(self)
        return False

    def __repr__(self):
        return ("Span(%d, %r, batch=%r, wait=%r, %s ns, counts=%r)"
                % (self.index, self.name, self.batch, self.wait,
                   None if self.end_ns is None
                   else self.end_ns - self.start_ns, self.counts))


# what `span` and `scope` return while the recorder is off
_OFF = contextlib.nullcontext()


class _Thread(threading.local):
    """A thread's open spans and its scope's batch id."""

    def __init__(self):
        self.stack = []
        self.batch = None


class _Scope:
    __slots__ = ("local", "batch", "before")

    def __init__(self, local, batch):
        self.local, self.batch = local, batch

    def __enter__(self):
        self.before = self.local.batch
        self.local.batch = self.batch

    def __exit__(self, *exc):
        self.local.batch = self.before
        return False


class Recorder:
    """Host spans and counts in a bounded buffer (`capacity` spans; the
    oldest go first, counted in `dropped`, the newest of them starting at
    `dropped_until_ns`). Spans nest per thread; a span's batch id is the
    one given, else its parent's, else the thread's `scope`'s. A thread
    with no open span of its own that runs a backward pass of the autograd
    engine (its CUDA threads) counts into the innermost open `shared` span
    of any thread; any other such thread's counts drop. One process's
    engine threads serve every thread's backward, so two threads that each
    hold a shared span open at once cannot tell their counts apart: the
    later span takes both."""

    def __init__(self, capacity: int = 65536):
        self.enabled = True
        self.spans = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.dropped_until_ns = None
        self._count = itertools.count()
        self._local = _Thread()
        self._shared = []

    def span(self, name: str, batch=None, wait: bool = False,
             shared: bool = False):
        """Context manager: a span named `name` around its body. `wait`:
        the host only blocks on the device in it. `shared`: its body's
        work runs on other threads too (the autograd engine's), whose
        counts land on it."""
        if not self.enabled:
            return _OFF
        return Span(self, name, batch, wait, shared)

    def scope(self, batch):
        """Context manager: spans opened in its body with no batch id of
        their own or of a parent take `batch`. Opens no span."""
        if not self.enabled:
            return _OFF
        return _Scope(self._local, batch)

    def count(self, name: str, n) -> None:
        """Add `n` (a host number) to the count `name` of this thread's
        innermost open span, else, in a backward pass on a thread of the
        autograd engine, of the innermost open shared span; nothing where
        none is open."""
        if not self.enabled:
            return
        stack = self._local.stack
        if not stack and torch._C._current_graph_task_id() != -1:
            stack = self._shared
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def open_counts(self) -> dict:
        """A copy of the counts of this thread's innermost open span ({}
        where none is open, or the recorder is off)."""
        stack = self._local.stack
        return dict(stack[-1].counts) if self.enabled and stack else {}

    def closed(self, since_ns=None, until_ns=None):
        """The closed spans that start at or after `since_ns` and end at or
        before `until_ns`, in the order they opened."""
        return [s for s in list(self.spans) if s.end_ns is not None
                and (since_ns is None or s.start_ns >= since_ns)
                and (until_ns is None or s.end_ns <= until_ns)]

    def summary(self, since_ns=None):
        """{name: {"count", "total_ms", "self_ms", "wait", "counts"}} of the
        closed spans since `since_ns`: self ms is a span's time less the
        part its child spans cover; counts are summed."""
        spans = self.closed(since_ns)
        covered = {}
        for s in spans:
            if s.parent is not None:
                covered[s.parent] = (covered.get(s.parent, 0)
                                     + s.end_ns - s.start_ns)
        out = {}
        for s in spans:
            d = s.end_ns - s.start_ns
            e = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                        "self_ms": 0.0, "wait": s.wait,
                                        "counts": {}})
            e["count"] += 1
            e["total_ms"] += d / 1e6
            e["self_ms"] += (d - covered.get(s.index, 0)) / 1e6
            for k, v in s.counts.items():
                e["counts"][k] = e["counts"].get(k, 0) + v
        return out

    def clear(self) -> None:
        """Forget every span (open ones close into nothing)."""
        self.spans.clear()
        self.dropped = 0
        self.dropped_until_ns = None


RECORDER = Recorder()
span = RECORDER.span
scope = RECORDER.scope
count = RECORDER.count
open_counts = RECORDER.open_counts
summary = RECORDER.summary
clear = RECORDER.clear


def _num(v) -> str:
    return "%d" % v if v == int(v) else "%.2f" % v


def summary_line(summ, units: int, unit: str) -> str:
    """One line of `summary()`: host ms per `unit` by span over `units` of
    them, self ms in brackets, waits marked, and each span's counts per
    `unit` in braces."""
    n = max(units, 1)
    parts = []
    for name, e in sorted(summ.items(), key=lambda kv: -kv[1]["total_ms"]):
        part = "%s%s %.3f (%.3f)" % (name, " [wait]" if e["wait"] else "",
                                     e["total_ms"] / n, e["self_ms"] / n)
        if e["counts"]:
            part += " {%s}" % ", ".join(
                "%s %s" % (k, _num(v / n))
                for k, v in sorted(e["counts"].items()))
        parts.append(part)
    return ("spans: host ms a %s over %d (self ms in brackets, counts a %s "
            "in braces): %s" % (unit, units, unit, ", ".join(parts) or "none"))
