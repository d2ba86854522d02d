"""Readings that the Kimi-VL cell's limits are set from: the program's,
over many seeds, and the control's, the reference put in the program's
place one precision below the configuration's.

    python -m vsrbench.control_vlm --seeds 11,12,13

For every seed, in one process: the cell's set-up at its own size, the
pool's batches once through the timed path (`run_stream`), then the
numbers that a run compares (`drivers/eval_stream_vlm.judge`), read two
ways:

  * program: the program's outputs against the float32 reference, as a
    run reads them;
  * control: along the program's served paths, the reference's own
    outputs with every expert product (routed and shared) on float8 e4m3
    inputs, activations and weights, a scale a row (the configuration
    states bfloat16; float8 is the next precision below), its own expert
    choices, against the float32 reference.

Prints one JSON line a seed, then one with the largest program reading
and the smallest control reading of each number. The runs of the
benchmark never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from types import SimpleNamespace

from vsrbench import harness, layout
from vsrbench import yardstick_vlm as yv
from vsrbench.drivers import eval_stream as es
from vsrbench.drivers import eval_stream_vlm as ev

CELL = "vsr-kimivl.vlm-stream-b256"


def readings(cell, seed, device):
    import torch
    cfg, tr = cell.config, cell.traffic
    w = ev.make_weights(cfg, seed, device)
    pipe = ev.build_program(cfg, w, device)
    pool = [es.make_batch(cfg, tr, seed, i, device)
            for i in range(tr["pool"])]
    captured = {"gen": [], "sink": [], "plan": [], "beam": []}
    es.instrument(pipe, harness.Spans(), captured)
    yields = [(0.0, words) for words in
              pipe.run_stream([b.stream for b in pool])]
    outputs = es.collect(captured, yields)
    del pipe, captured
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog, _ = ev.judge(cfg, tr, w, pool, outputs, seed, cell.limits)
    control = SimpleNamespace(config=dict(yv.model(cfg),
                                          expert_inputs="float8_e4m3fn"))
    ctrl, _ = ev.judge(cfg, tr, w, pool, outputs, seed, cell.limits,
                       control)
    return ({k: v["value"] for k, v in prog.items()},
            {k: v["value"] for k, v in ctrl.items()})


def main(argv=None, root=None, device=None):
    ap = argparse.ArgumentParser(prog="vsrbench.control_vlm")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = layout.cell(CELL, root)
    dev = (harness.claim_device(cell.chips) if device is None
           else torch.device(device))
    worst_p, least_c = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog, ctrl = readings(cell, seed, dev)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in prog.items():
            worst_p[k] = max(worst_p.get(k, v), v)
        for k, v in ctrl.items():
            least_c[k] = min(least_c.get(k, v), v)
    print(json.dumps({"program_largest": worst_p,
                      "control_smallest": least_c,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
