"""The program's own spans (the recorder of
`vsrcic_tpu_torch.utils.observability`), as the per-layer metrics read
them.

Over the window they are read on the perf_counter clock, which the
harness's spans share. In the traced slice they are mapped onto the
profiler's clock by the harness's unit spans (`vsrbench.unit`), which stand
on both clocks: the offset is the median difference of their starts and
ends. Each idle instant of the slice (no device operation in
`slice.kernels` inside `slice.window_us`) is then given to the innermost
program span open at that instant.

A program without the recorder, or a window in which the recorder dropped
spans, gives None everywhere, so the metrics that read it fall silent.
"""
from __future__ import annotations

import bisect
import statistics
import sys

from vsrbench.harness import UNIT_SPAN


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from vsrcic_tpu_torch.utils import observability
    except ImportError:
        return None
    rec = getattr(observability, "RECORDER", None)
    return rec if hasattr(rec, "closed") else None


def window_spans(ctx):
    """The program's closed spans inside the window `ctx.window` (perf
    counter seconds), or None."""
    rec = recorder()
    if rec is None or not ctx.units:
        return None
    lo, hi = (round(t * 1e9) for t in ctx.window)
    if rec.dropped and rec.dropped_until_ns >= lo:
        return None
    return rec.closed(lo, hi)


def total_ms(spans, names):
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e6


def waits_under_ms(spans, names):
    """ms of the wait spans that have an ancestor named in `names`."""
    by_index = {s.index: s for s in spans}
    total = 0
    for s in spans:
        if s.wait and any(a.name in names for a in ancestors(s, by_index)):
            total += s.end_ns - s.start_ns
    return total / 1e6


def ancestors(s, by_index):
    while s.parent is not None and s.parent in by_index:
        s = by_index[s.parent]
        yield s


def clock_offset_us(ctx):
    """The profiler's clock less the perf_counter clock, in us: the median
    difference of the slice's unit spans (the last units the harness ran)
    on the two clocks; None without them."""
    prof = sorted((s, e) for n, s, e in ctx.slice.host if n == UNIT_SPAN)
    perf = sorted((s, e) for n, s, e in ctx.spans.items if n == UNIT_SPAN)
    n = min(len(prof), len(perf))
    if not n:
        return None
    return statistics.median(
        p - 1e6 * q for (ps, pe), (qs, qe) in zip(prof[-n:], perf[-n:])
        for p, q in ((ps, qs), (pe, qe)))


class Busy:
    """The device's busy time before an instant, from the slice's
    operations (merged)."""

    def __init__(self, kernels):
        merged = []
        for s, e in sorted((s, e) for _, s, e in kernels):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def upto(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]


def idle_by_span(ctx):
    """({span or None: idle us}, units) over the traced slice's window:
    each idle instant goes to the innermost program span open at it (None:
    no program span open); `units` is the number of the window's units.
    None without a device trace, a recorder, the unit spans, or where the
    recorder dropped spans of the slice."""
    sl = ctx.slice
    if sl is None or not sl.window_us or not sl.kernels:
        return None
    rec, off = recorder(), clock_offset_us(ctx)
    if rec is None or off is None:
        return None
    lo, hi = sl.window_us
    units = [s for n, s, _ in sl.host if n == UNIT_SPAN]
    if rec.dropped and rec.dropped_until_ns / 1e3 + off >= min(units):
        return None
    spans = [(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s)
             for s in rec.closed()]
    spans = [x for x in spans if x[1] > lo and x[0] < hi]
    busy = Busy(sl.kernels)
    cuts = sorted({lo, hi} | {min(max(t, lo), hi)
                              for a, b, _ in spans for t in (a, b)})
    out = {}
    for a, b in zip(cuts, cuts[1:]):
        idle = (b - a) - (busy.upto(b) - busy.upto(a))
        if idle <= 0:
            continue
        inner = max(((x, s.index, s) for x, y, s in spans
                     if x <= a and y >= b), default=None,
                    key=lambda v: v[:2])
        key = None if inner is None else inner[2]
        out[key] = out.get(key, 0.0) + idle
    return out, sum(1 for s in units if s >= lo)


def host_idle_ms(ctx, root=None):
    """Device idle ms a traced unit whose innermost program span is host
    work (not a wait), under a span named `root` where given (the span
    itself included). Prints the whole split by span name."""
    got = idle_by_span(ctx)
    if got is None:
        return None
    split, units = got
    if not units:
        return None
    report(split, units)
    spans = [s for s in split if s is not None]
    by_index = {s.index: s for s in recorder().closed()}
    total = 0.0
    for s in spans:
        if s.wait:
            continue
        if root is not None and s.name != root and not any(
                a.name == root for a in ancestors(s, by_index)):
            continue
        total += split[s]
    return total / 1e3 / units


def report(split, units):
    """One line on standard error: the slice's idle ms a unit by innermost
    span name, and the share under a program span."""
    by_name = {}
    for s, us in split.items():
        name = "outside the program's spans" if s is None else (
            s.name + (" [wait]" if s.wait else ""))
        by_name[name] = by_name.get(name, 0.0) + us
    whole = sum(by_name.values())
    named = whole - by_name.get("outside the program's spans", 0.0)
    print("vsrbench: device idle in the traced slice by innermost program "
          "span, ms a unit over %d: %s; %.1f%% of %.3f ms a unit under a "
          "program span"
          % (units, ", ".join("%s %.3f" % (n, us / 1e3 / units) for n, us in
                              sorted(by_name.items(), key=lambda kv: -kv[1])),
             100.0 * named / whole if whole else 0.0, whole / 1e3 / units),
          file=sys.stderr)
