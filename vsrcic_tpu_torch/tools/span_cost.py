"""What the recorder's spans cost the host, with and without an active
profiler.

    python3 -m vsrcic_tpu_torch.tools.span_cost [--spans 200000]

Times `--spans` spans (each with one count, opened inside one outer span,
as the program opens them) on a fresh `observability.Recorder`: on, off,
and on under an active `torch.profiler` (CPU activity, and CUDA where
there is a card, as the benchmark's traced slice runs it), in turns, three
rounds each. Prints one JSON line: microseconds a span for each, the best
of the rounds, and the card's name and power limit where there is one.

The recorder is always on in the program; what a batch or step pays is
the cost of a span times the spans it opens. What that costs a benchmark
cell's rate: `python3 -m vsrbench.span_ab`.
"""
import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from vsrcic_tpu_torch.utils import observability as obs


def time_spans(rec, n):
    with rec.span("cost.outer"):
        t0 = time.perf_counter()
        for i in range(n):
            with rec.span("cost.span"):
                rec.count("n", 1)
        dt = time.perf_counter() - t0
    rec.clear()
    return 1e6 * dt / n


def card_name():
    if not torch.cuda.is_available():
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="span_cost")
    ap.add_argument("--spans", type=int, default=200000)
    args = ap.parse_args(argv)
    card = card_name()
    acts = [ProfilerActivity.CPU]
    if card is not None:
        acts.append(ProfilerActivity.CUDA)
    rec = obs.Recorder(capacity=args.spans + 2)
    out = {"on": [], "off": [], "profiler": []}
    for _ in range(3):
        rec.enabled = True
        out["on"].append(time_spans(rec, args.spans))
        rec.enabled = False
        out["off"].append(time_spans(rec, args.spans))
        rec.enabled = True
        with profile(activities=acts):
            out["profiler"].append(time_spans(rec, args.spans // 10))
    print(json.dumps({"us_a_span": {k: min(v) for k, v in out.items()},
                      "rounds": out, "spans": args.spans, "card": card}))


if __name__ == "__main__":
    main()
