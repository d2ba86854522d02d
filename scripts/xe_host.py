#!/usr/bin/env python3
"""Host ms an XE step by program span, Python's collections, and the step
products' own host cost a call.

    python3 scripts/xe_host.py [SEED] [STEPS]   # from a checkout's root

Builds `captioner-coco.xe-b1024`'s program, weights and batch pool from
SEED (default 2718281829) as `vsrbench/drivers/xe_train.py` does, warms
up on six steps, then times STEPS more (default 30) with the recorder
cleared before them. Prints the card's name and power limit; the wall ms
a step; the recorder's `summary_line` (host ms a step by span, self ms,
counts); Python's garbage collections in those steps by generation, with
their count and ms. Where the checkout has the autograd step products
(`ops/step_planes.py::step_planes_autograd`), also their host us a call,
forward and backward, at a tiny shape where the card waits on the host,
beside `nn.linear`'s at the same shape. The checkout it measures is the
working directory's, so the same script reads a parent's tree unpacked
beside it.
"""
import gc
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def collections(steps_fn):
    """Run `steps_fn` and return {generation: [count, ms]} of the garbage
    collections Python made meanwhile."""
    seen, start = {}, {}

    def cb(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            e = seen.setdefault(info["generation"], [0, 0.0])
            e[0] += 1
            e[1] += 1e3 * (time.perf_counter() - start["t"])
    gc.callbacks.append(cb)
    try:
        steps_fn()
    finally:
        gc.callbacks.remove(cb)
    return seen


def per_call_us(fn, calls=2000):
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def op_cost(dev):
    """(step products' us, nn.linear's us) a forward and backward call at
    rows 8, K 64 in two segments, N 64; None where there is no such op."""
    import torch
    from vsrcic_tpu_torch.ops import step_planes as sp
    if not hasattr(sp, "step_planes_autograd"):
        return None
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((64, 64), generator=g, device=dev, requires_grad=True)
    b = torch.randn((64,), generator=g, device=dev, requires_grad=True)
    xs = [torch.randn((8, 32), generator=g, device=dev, requires_grad=True)
          for _ in range(2)]
    sw = sp.step_grad_weights(w, b)

    def planes():
        y = sp.step_planes_autograd(xs, sw)
        torch.autograd.grad(y.sum(), [w, b, *xs])

    def linear():
        y = torch.nn.functional.linear(torch.cat(xs, 1), w, b)
        torch.autograd.grad(y.sum(), [w, b, *xs])
    return per_call_us(planes), per_call_us(linear)


def main(argv):
    import torch
    from vsrbench import layout
    from vsrbench.drivers import xe_train as xt
    from vsrcic_tpu_torch.utils import observability as obs
    if not torch.cuda.is_available():
        print("xe_host: no CUDA card", file=sys.stderr)
        return 2
    seed = int(argv[0]) if argv else 2718281829
    n = int(argv[1]) if len(argv) > 1 else 30
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cell = layout.cell("captioner-coco.xe-b1024")
    cfg, tr = cell.config, cell.traffic
    trainer = xt.build_program(cfg, xt.make_weights(cfg, seed, dev), dev)
    pool = [xt.make_batch(cfg, tr, seed, i, dev) for i in range(tr["pool"])]
    for i in range(6):
        trainer.step(*pool[i % len(pool)])
    torch.cuda.synchronize()
    obs.clear()
    t = {}

    def steps():
        t0 = time.perf_counter()
        for i in range(n):
            trainer.step(*pool[i % len(pool)])
        torch.cuda.synchronize()
        t["s"] = time.perf_counter() - t0
    gcs = collections(steps)
    print("card %s; %d steps in %.3f s: %.1f ms a step, %.1f samples/s"
          % (card.strip(), n, t["s"], 1e3 * t["s"] / n,
             n * tr["batch"] / t["s"]))
    print(obs.summary_line(obs.summary(), n, "step"))
    print("collections in %d steps: %s" % (n, ", ".join(
        "generation %d: %d, %.1f ms" % (gen, c, ms)
        for gen, (c, ms) in sorted(gcs.items())) or "none"))
    cost = op_cost(dev)
    if cost:
        print("host us a forward and backward call at rows 8, K 64, N 64: "
              "step products %.1f, nn.linear %.1f" % cost)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
