"""One run of one cell of the benchmark of `vsrcic_tpu_torch`.

    python -m vsrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `vsrbench/` and
the program. Set-up (weights and inputs made on the card from the seed,
the program built and warmed on the cell's shapes) runs first and is timed
from process start; then the cell's traffic runs for `--seconds`; then the
program's outputs are compared with the plain reference. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device` and, traced, `breakdown`; the numbers
compared, each beside its limit, come last there and on standard error.

With no CUDA card, or fewer than the cell asks for, it exits non-zero and
prints no result. It exits non-zero and prints no result too if, once the
window has closed, JAX, jaxlib, flax or the JAX package `vsrcic_tpu` is
loaded in this process.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

from vsrbench import harness

# the clock's origin: the start of this process
T_PROCESS = time.perf_counter() - harness.process_age_s()


def parse(argv):
    ap = argparse.ArgumentParser(prog="vsrbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root=None, device=None):
    """`device` (tests only): run on that device instead of claiming a
    card."""
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from vsrbench import layout
    cell = layout.cell(args.workload, root)
    import torch
    dev = (harness.claim_device(cell.chips) if device is None
           else torch.device(device))
    # the configurations state float32 step math with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module("vsrbench.drivers."
                                     + cell.traffic["driver"])
    result, checks = driver.run(cell, args, dev, T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print("vsrbench: modules of JAX or the JAX package are loaded: %s"
              % ", ".join(bad), file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
