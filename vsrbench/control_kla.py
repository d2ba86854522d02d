"""Readings that the Kimi-Linear cell's limits are set from: the
program's, over many seeds, and two controls', the reference put in the
program's place one precision below the configuration's.

    python -m vsrbench.control_kla --seeds 11,12,13

For every seed, in one process: the cell's set-up at its own size, the
pool's batches once through the timed path (`run_stream`), then the
numbers that a run compares (`drivers/eval_stream_kla.judge`), read
three ways:

  * program: the program's outputs against the float32 reference, as a
    run reads them;
  * bf16_state: along the program's served paths, the reference's own
    outputs with the KDA state rounded to bf16 after every update (the
    configuration states f32), its own expert choices; the probed step
    computed likewise from the program's inputs;
  * float8_experts: the same with every expert product (routed and
    shared) on float8 e4m3 inputs, a scale a row (the configuration
    states bf16), the state in f32.

Prints one JSON line a seed, then one with the largest program reading
and the smallest reading of each control. The runs of the benchmark never
run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from types import SimpleNamespace

from vsrbench import harness, layout
from vsrbench.drivers import eval_stream as es
from vsrbench.drivers import eval_stream_kla as ek

CELL = "vsr-kimilinear.kda-stream-b128"
CONTROLS = {"bf16_state": {"kda_state": "bfloat16"},
            "float8_experts": {"expert_inputs": "float8_e4m3fn"}}


def readings(cell, seed, device):
    import torch
    cfg, tr = cell.config, cell.traffic
    w = ek.make_weights(cfg, seed, device)
    pipe = ek.build_program(cfg, w, device)
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
    out = {}
    prog, _ = ek.judge(cfg, tr, w, pool, outputs, seed, cell.limits)
    out["program"] = {k: v["value"] for k, v in prog.items()}
    for name, precision in CONTROLS.items():
        control = SimpleNamespace(config=ek.ref_config(cfg, **precision))
        got, _ = ek.judge(cfg, tr, w, pool, outputs, seed, cell.limits,
                          control)
        out[name] = {k: v["value"] for k, v in got.items()}
    return out


def main(argv=None, root=None, device=None):
    ap = argparse.ArgumentParser(prog="vsrbench.control_kla")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = layout.cell(CELL, root)
    dev = (harness.claim_device(cell.chips) if device is None
           else torch.device(device))
    worst = {}
    least = {name: {} for name in CONTROLS}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, dev)
        print(json.dumps(dict(seed=seed, seconds=time.perf_counter() - t0,
                              **got)), flush=True)
        for k, v in got["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for name in CONTROLS:
            for k, v in got[name].items():
                least[name][k] = min(least[name].get(k, v), v)
    print(json.dumps({"program_largest": worst, "control_smallest": least,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
