"""What every run of the benchmark shares: the card check, the seeds, the
clock from process start, host spans, the profiler's slice of the window
and its reduction, the per-layer metrics' readers, the modules check and
the result line.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

from vsrbench import yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "vsrcic_tpu")
UNIT_SPAN = "vsrbench.unit"


def process_age_s():
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against the boot clock); 0.0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - start)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def seed_seq(seed, *keys):
    """A numpy SeedSequence from the run's seed (any whole number) and
    stream keys."""
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                   int(seed) >> 64, *keys])


def numpy_rng(seed, *keys):
    return np.random.default_rng(seed_seq(seed, *keys))


def torch_gen(seed, device, *keys):
    import torch
    state = int(seed_seq(seed, *keys).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def claim_device(chips):
    """The card, or SystemExit when there is none or too few."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("vsrbench: torch.cuda.is_available() is false; the "
                         "benchmark runs on CUDA cards only")
    if torch.cuda.device_count() < chips:
        raise SystemExit("vsrbench: the cell asks for %d cards, %d present"
                         % (chips, torch.cuda.device_count()))
    return torch.device("cuda", 0)


def card_info(device):
    """Name, power limit (W) and count of the cards, as the driver of the
    card reports them."""
    import torch
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit_w": None}
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(out.split(",")[-1])
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


class Spans:
    """Host spans kept in memory: (name, start, end) on the perf_counter
    clock, and, while a profiler runs, the same ranges in its trace."""

    def __init__(self, record_function=None):
        self.items = []
        self._rf = record_function

    @contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        if self._rf is not None:
            with self._rf(name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def wrap(self, obj, name, keep=None):
        """Replace the bound method obj.name by one inside a span; `keep`
        (optional) is called with each result."""
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            with self.span(name):
                out = fn(*a, **kw)
            if keep is not None:
                keep(out)
            return out
        setattr(obj, name, wrapped)

    def total(self, names, since=-math.inf, until=math.inf):
        return sum(e - s for n, s, e in self.items
                   if n in names and s >= since and e <= until)


class Tracer:
    """torch.profiler over a slice of units run once the window has
    closed: `active` units after `wait` units (and one of warm-up), one
    unit a `step()` call. After the slice its events are reduced to plain
    tuples: device operations (name, start us, end us) and host spans
    (name, start us, end us)."""

    def __init__(self, device, wait, active):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU]
        self._sync = lambda: None
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            self._sync = torch.cuda.synchronize
        self.first = wait + 1
        self.active = active
        self.units = 0
        self.kernels = None
        self.host = None
        self.boundary = {}
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=wait, warmup=1,
                                              active=active, repeat=1),
                            on_trace_ready=self._reduce)

    def start(self):
        self.prof.start()

    def step(self, counters):
        """End of one unit. At the slice's two edges the device is drained
        first, so that the slice's operations are exactly those its units
        launched, and `counters` is read."""
        self.units += 1
        if self.units in (self.first, self.first + self.active):
            self._sync()
            self.boundary[self.units] = counters()
        self.prof.step()

    @property
    def done(self):
        return self.units >= self.first + self.active

    def stop(self):
        self.prof.stop()

    def _reduce(self, prof):
        from torch.autograd import DeviceType
        kernels, host = [], []
        for e in prof.events():
            rng = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                kernels.append(rng)
            elif e.device_type == DeviceType.CPU:
                host.append(rng)
        names = {n for n, _, _ in host}
        # a host range shows on the device's timeline under its own name
        self.kernels = [k for k in kernels if k[0] not in names]
        self.host = host

    def counters_delta(self):
        a = self.boundary.get(self.first)
        b = self.boundary.get(self.first + self.active)
        if a is None or b is None:
            return None
        return {k: b[k] - a[k] for k in a}

    def window(self):
        """(start us, end us) of the slice's units after the first (which
        starts on a drained device), or None."""
        units = sorted((s, e) for n, s, e in (self.host or [])
                       if n == UNIT_SPAN)
        if len(units) > 1:
            units = units[1:]
        if not units:
            return None
        return units[0][0], max(e for _, e in units)


def base_name(name):
    """A kernel's name without its return type and anonymous namespace:
    'void (anonymous namespace)::vocab_merge_kernel(int, ...)' ->
    'vocab_merge_kernel(int, ...)'."""
    if name.startswith("void "):
        name = name[5:]
    while name.startswith("(anonymous namespace)::"):
        name = name[len("(anonymous namespace)::"):]
    return name


class Slice:
    """The reduced trace of the traced units, as the metrics read it."""

    def __init__(self, tracer, span_names):
        self.window_us = tracer.window()
        lo, hi = self.window_us or (0.0, 0.0)
        # every device operation the slice's units launched, and the same
        # clipped to the units' host time (busy and idle)
        self.launched = list(tracer.kernels or [])
        self.kernels = [(n, max(s, lo), min(e, hi))
                        for n, s, e in self.launched if e > lo and s < hi]
        self.host = [(n, s, e) for n, s, e in (tracer.host or [])
                     if n in span_names]
        self.units = sum(1 for n, _, _ in (tracer.host or [])
                         if n == UNIT_SPAN)      # every unit's launches
        self.counters = tracer.counters_delta()
        self.start = tracer.boundary.get(tracer.first)

    @property
    def window_s(self):
        return (self.window_us[1] - self.window_us[0]) / 1e6 \
            if self.window_us else 0.0

    @property
    def busy_s(self):
        return yardstick.union_us([(s, e) for _, s, e in self.kernels]) / 1e6

    def device_ms(self, prefixes):
        """Summed device ms of the operations the slice launched whose
        `base_name` starts with one of `prefixes`, and their count."""
        total, count = 0.0, 0
        for n, s, e in self.launched:
            if base_name(n).startswith(tuple(prefixes)):
                total += e - s
                count += 1
        return total / 1e3, count

    def breakdown(self, top=10):
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host span around its start
        (`vsrbench.unit`: inside a unit, outside the program's named
        calls)."""
        by_name = {}
        for n, s, e in self.launched:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = sorted((s, e) for _, s, e in self.kernels)
        merged = []
        for s, e in busy:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        lo, hi = self.window_us or (0.0, 0.0)
        edges = [lo] + [x for m in merged for x in m] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:top]:
            around = [(hs, he, n) for n, hs, he in self.host
                      if hs <= s < he]
            name = (max(around)[2] if around else "outside the spans")
            named.append([name, (e - s) / 1e6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def stage_line(stages):
    """'name s, ...' of each set-up stage's seconds."""
    return ", ".join("%s %.3f" % (n, t - stages[i][1])
                     for i, (n, t) in enumerate(stages[1:]))


def load_metric(path):
    """A per-layer metric's module from its file (the name may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(
        "vsrbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell, ctx):
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    reader found something to read."""
    out = {}
    for m in cell.per_layer:
        value = load_metric(cell.metric_file(m["name"])).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def emit(result, checks):
    """The checks as the last lines of standard error and as the last key
    of the result line, which is the last line of standard output."""
    result = dict(result)
    result["checks"] = checks
    for name, c in checks.items():
        print("vsrbench: check %s %r limit %r" % (name, c["value"],
                                                  c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
