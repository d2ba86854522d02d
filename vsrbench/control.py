"""Readings that the limits of the output checks are set from: the
program's, over many seeds, and the control's, the reference put in the
program's place one precision below the configuration's.

    python -m vsrbench.control --workload <cell> --seeds 11,12,13 [--faults]

For every seed, in one process: the cell's set-up at its own size, a short
stretch of its own traffic through the timed path (the eval stream's
`check_batches` batches; or XE's set-up steps, LATE_AFTER more and one
from the program's state after them, as a run makes after its window),
then the numbers that a run compares, read three ways:

  * program: the program's outputs against the float32 reference, as a
    run reads them;
  * control: at the same positions (the program's served roles and beam
    paths), the reference's own outputs computed with TF32 on (the
    configurations state float32 with TF32 off), against the float32
    reference. On a device without TF32 the control's weights are rounded
    to TF32's 10-bit mantissa instead (the CPU tests' stand-in);
  * with --faults (XE): half of the batch left out, the mean taken over
    the rest, in the reference put in the program's place.

Prints one JSON line a seed, then one with the largest program reading
and the smallest control (and fault) reading of each number. The runs of
the benchmark never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from contextlib import contextmanager

from vsrbench import harness, layout

LATE_AFTER = 20     # XE steps between set-up's and the late one (the window)


def tf32_round(tree):
    """Every tensor of a nested dict rounded to TF32's 10-bit mantissa
    (nearest, ties away from zero)."""
    import torch
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tf32_round(v)
        else:
            bits = v.float().contiguous().view(torch.int32)
            out[k] = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return out


class Control:
    """The reference one precision below the configuration's."""

    def __init__(self, w, device):
        self.device = device
        self.weights = (w if device.type == "cuda"
                        else {k: tf32_round(v) if isinstance(v, dict)
                              and k != "tense_map" else v
                              for k, v in w.items()})

    @contextmanager
    def precision(self):
        import torch
        if self.device.type != "cuda":
            yield
            return
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def eval_readings(cell, seed, device):
    import torch
    from vsrbench.drivers import eval_stream as es
    cfg, tr = cell.config, cell.traffic
    w = es.make_weights(cfg, seed, device)
    pipe = es.build_program(cfg, w, device)
    pool = [es.make_batch(cfg, tr, seed, i, device)
            for i in range(tr["pool"])]
    captured = {"gen": [], "sink": [], "plan": [], "beam": []}
    es.instrument(pipe, harness.Spans(), captured)
    n = tr["check_batches"]
    words = list(pipe.run_stream([pool[i % len(pool)].stream
                                  for i in range(n)]))
    outputs = es.collect(captured, [(0.0, x) for x in words])
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ctrl = Control(w, device)
    keys = es.NUMBERS
    got = {"program": dict.fromkeys(keys, 0.0),
           "control": dict.fromkeys(keys, 0.0)}
    rng = harness.numpy_rng(seed, 30)
    judged = 0
    for i, out in enumerate(outputs):
        batch = pool[i % len(pool)]
        at = es.search_block(tr, rng)
        for side, c in (("program", None), ("control", ctrl)):
            r = es.judge_batch(cfg, tr, w, batch, out, cell.limits, c, at)
            for k in keys:
                got[side][k] = max(got[side][k], r[k])
        judged += r["search_judged"]
    del got["control"]["plan_exact"]
    got["search_judged"] = [judged, n * tr["judge_block"]]
    return got


def xe_readings(cell, seed, device, faults):
    import torch
    from vsrbench.drivers import xe_train as xt
    cfg, tr = cell.config, cell.traffic
    p0 = xt.make_weights(cfg, seed, device)
    trainer = xt.build_program(cfg, p0, device)
    pool = [xt.make_batch(cfg, tr, seed, i, device)
            for i in range(tr["pool"])]
    k = tr["check_steps"]
    got = xt.first_steps(trainer, pool, p0, k, cfg["optim"]["betas"][0])
    for i in range(k, k + LATE_AFTER):
        trainer.step(*pool[i % len(pool)])
    batch = pool[(k + LATE_AFTER) % len(pool)]
    before, got_late = xt.late_step(trainer, batch,
                                    cfg["optim"]["betas"][0])
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = xt.reference_steps(cfg, tr, p0, pool, k)
    ref_late = xt.reference_late(cfg, tr, before, batch)

    def sides(start, late):
        matched = dict(ref, losses=xt.losses_at(cfg, tr, start, pool, ref))
        r = (xt.readings(cfg, start, matched),
             xt.readings(cfg, late, ref_late))
        return {"worst": xt.worst_of(*r), "setup": _xe_keys(r[0]),
                "late": _xe_keys(r[1])}
    out = {"program": sides(got, got_late)}
    ctrl = Control({"captioner": p0, "late": before["params"]}, device)
    low_before = dict(before, params=ctrl.weights["late"])
    with ctrl.precision():
        low = xt.reference_steps(cfg, tr, ctrl.weights["captioner"], pool, k)
        low_late = xt.reference_late(cfg, tr, low_before, batch)
    out["control"] = sides(low, low_late)
    if faults:
        half = [tuple(x[: x.shape[0] // 2] for x in b) for b in pool]
        out["half_batch"] = sides(
            xt.reference_steps(cfg, tr, p0, half, k),
            xt.reference_late(cfg, tr, before, half[(k + LATE_AFTER)
                                                    % len(pool)]))
    return {side: dict(r["worst"], setup=r["setup"], late=r["late"])
            for side, r in out.items()}


def _xe_keys(r):
    return {k: r[k] for k in ("loss_gap", "grad_gap", "update_gap",
                              "loss_at", "grad_at", "update_at")}


def main(argv=None, root=None, device=None):
    ap = argparse.ArgumentParser(prog="vsrbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    import torch
    cell = layout.cell(args.workload, root)
    dev = (harness.claim_device(cell.chips) if device is None
           else torch.device(device))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["driver"] == "eval_stream":
            r = eval_readings(cell, seed, dev)
        else:
            r = xe_readings(cell, seed, dev, args.faults)
        r["seed"] = seed
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for side in rows[0]:
        if not isinstance(rows[0][side], dict):
            continue
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[side][k] for r in rows)
                         for k, v in rows[0][side].items()
                         if not isinstance(v, dict)}
    print(json.dumps({"summary": summary, "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
