#!/usr/bin/env python3
"""Device ms a batch of the Kimi-Linear decoder's KDA layers, prefill and
decode apart, and the kernels that take it.

    python3 scripts/kda_split.py [BATCHES]    # from a checkout's root

Builds chip_smoke.py's Kimi-Linear captioner (`kimi_captioner(linear=
True)`: the `vsr-kimilinear` cell's published widths and depth, 64 of the
256 experts held, 128 jobs of 40-100 real detections, beam 5), runs three
batches (eager, captured as CUDA graphs, replayed), then BATCHES more
(default 2) under torch.profiler. Each device operation is joined to the
host call that launched it (a kernel's launch, or the launch of a CUDA
graph whose kernels it ran) by the profiler's correlation id, and given
to the program's span `vlm.kda`, `vlm.moe` or `vlm.attn` open at that
launch ("other" outside them), at prefill when `vlm.prefill` was open
too. Prints the card's name and power limit, the wall ms a batch, device
ms a batch by span and phase, and the kernels that take most of
`vlm.kda`'s; writes chiprun_out/kda_split.json. The checkout it measures
is the working directory's, so the same script reads a parent's tree
unpacked beside it.
"""
import bisect
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

SPANS = ("vlm.kda", "vlm.moe", "vlm.attn")


def split(prof):
    """{(phase, span): ms}, {(phase, kernel): ms} over the profiled
    batches: each device operation given to the span open at its
    launch."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    # a host range shows on the device's timeline under its own name
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    ranges, prefill, launches, device = [], [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in host:
                device.append((e.correlation_id(), e.duration_ns(), name))
        elif name in SPANS:
            ranges.append((e.start_ns(), e.end_ns(), name))
        elif name == "vlm.prefill":
            prefill.append((e.start_ns(), e.end_ns()))
        elif name.startswith("cuda") and "Launch" in name:
            launches[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_span, by_kernel = {}, {}
    for corr, dur, name in device:
        t = launches.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1   # the spans do not nest
        span = ranges[i][2] if i >= 0 and ranges[i][1] >= t else "other"
        phase = ("prefill" if any(a <= t <= b for a, b in prefill)
                 else "decode")
        by_span[phase, span] = by_span.get((phase, span), 0.0) + dur / 1e6
        if span == "vlm.kda":
            key = phase, name[:90]
            by_kernel[key] = by_kernel.get(key, 0.0) + dur / 1e6
    return by_span, by_kernel


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("kda_split: no CUDA card", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else 2
    import chip_smoke as cs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cap, (dets, groups, verbs) = cs.kimi_captioner(linear=True)

    def batch():
        res = cap.beam_search_v(dets, groups, verbs, eos_word=3,
                                beam_size=cs.BEAM)
        torch.cuda.synchronize()
        return res
    for _ in range(3):
        batch()
    t0 = time.perf_counter()
    for _ in range(n):
        batch()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            batch()
    by_span, by_kernel = split(prof)
    out = {"card": card, "batches": n, "wall_ms": wall_ms,
           "span_ms": {"%s %s" % k: v / n for k, v in sorted(
               by_span.items())},
           "kda_kernels_ms": {"%s %s" % k: v / n for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:40]}}
    print("card %s; %d batches, %.1f ms a batch unprofiled" % (card, n,
                                                             wall_ms))
    for k, v in out["span_ms"].items():
        print("  %-22s %9.2f ms a batch" % (k, v))
    print("  vlm.kda's kernels, ms a batch:")
    for k, v in list(out["kda_kernels_ms"].items())[:24]:
        print("    %8.2f  %s" % (v, k))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kda_split.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
