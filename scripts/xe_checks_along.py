#!/usr/bin/env python3
"""XE's checks sampled along training, as the XE cell's late step judges one.

    python3 scripts/xe_checks_along.py [SEED] [STEPS] [EVERY] [FIRST]
                                       # from a checkout's root, on a card

Builds `captioner-coco.xe-b1024`'s program, weights and batch pool from
SEED (default 2718281829) as `vsrbench/drivers/xe_train.py` does, takes
its `check_steps` set-up steps, then trains on the pool in the driver's
order up to step STEPS (default 300; steps count from 1, set-up's
included). Every EVERY steps (default 10) from step FIRST (default 100)
the step is the driver's late step (`late_step`): the reference takes it
from the same state (`reference_late`) and the gaps are read as the
driver reads them (`readings`), each printed beside the cell's limit.
Then the medians and the largest, and the step at which the driver's late
step falls: set-up's steps, plus the steps of a `run_seconds` window at
the rate measured here between samples, plus one. The checkout it
measures is the working directory's, so the same script reads a parent's
tree unpacked beside it.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def main(argv):
    import torch
    from vsrbench import layout
    from vsrbench.drivers import xe_train as xt
    if not torch.cuda.is_available():
        print("xe_checks_along: no CUDA card", file=sys.stderr)
        return 2
    seed = int(argv[0]) if argv else 2718281829
    steps = int(argv[1]) if len(argv) > 1 else 300
    every = int(argv[2]) if len(argv) > 2 else 10
    first = int(argv[3]) if len(argv) > 3 else 100
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cell = layout.cell("captioner-coco.xe-b1024")
    cfg, tr, limits = cell.config, cell.traffic, cell.limits
    with open("BENCHMARK.json") as f:
        run_seconds = json.load(f)["run_seconds"]
    b1 = cfg["optim"]["betas"][0]
    p0 = xt.make_weights(cfg, seed, dev)
    trainer = xt.build_program(cfg, p0, dev)
    pool = [xt.make_batch(cfg, tr, seed, i, dev) for i in range(tr["pool"])]
    k = tr["check_steps"]
    xt.first_steps(trainer, pool, p0, k, b1)
    print("card %s; seed %d; limits %s" % (card.strip(), seed, limits))
    got, timed_s, timed_steps = [], 0.0, 0
    step = k
    while step < steps:
        n = (max(first, step + 1) if step < first else step + every) - step
        n = min(n, steps - step) - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.step(*pool[step % len(pool)])
            step += 1
        torch.cuda.synchronize()
        timed_s += time.perf_counter() - t0
        timed_steps += n
        batch = pool[step % len(pool)]
        before, late = xt.late_step(trainer, batch, b1)
        step += 1
        r = xt.readings(cfg, late, xt.reference_late(cfg, tr, before, batch))
        got.append(r)
        print("step %d: %s (gradient at %s, change at %s)"
              % (step, ", ".join("%s %.3e" % (name, r[name])
                                 for name in xt.NUMBERS),
                 r["grad_at"], r["update_at"]), flush=True)
    if not got:
        return 0
    print("%d samples: %s" % (len(got), "; ".join(
        "%s median %.3e largest %.3e (limit %g)"
        % (name, statistics.median(r[name] for r in got),
           max(r[name] for r in got), limits[name])
        for name in xt.NUMBERS)))
    if timed_steps:
        rate = timed_steps / timed_s
        print("%.3f steps/s between samples (%.1f samples/s): the driver's "
              "late step of a %g s window falls at step ~%d"
              % (rate, rate * tr["batch"], run_seconds,
                 k + round(rate * run_seconds) + 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
