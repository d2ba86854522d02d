#!/usr/bin/env python3
"""Host ms a batch by program span of the eval cell's program, streamed.

    python3 scripts/stream_spans.py [SEED] [BATCHES]   # from a checkout's root

Builds `vsr-coco.stream-b512`'s program, weights and inputs from SEED
(default 2718281829) as `vsrbench/drivers/eval_stream.py` does,
streams two batches through `EvalPipeline.run_stream` to warm up (a
decode shape's step graphs are captured on its second batch), then BATCHES
more (default 40) with the recorder cleared before them. Prints the card's
name and power limit, the wall time a batch, and the recorder's
`summary_line`: host ms a batch by span (`beam.step`, `eval.planner`, ...),
self ms and counts. The checkout it measures is the working directory's,
so the same script reads a parent's tree unpacked beside it.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def main(argv):
    import torch
    from vsrbench import layout
    from vsrbench.drivers import eval_stream as es
    from vsrcic_tpu_torch.utils import observability as obs
    if not torch.cuda.is_available():
        print("stream_spans: no CUDA card", file=sys.stderr)
        return 2
    seed = int(argv[0]) if argv else 2718281829
    n = int(argv[1]) if len(argv) > 1 else 40
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cell = layout.cell("vsr-coco.stream-b512")
    cfg, tr = cell.config, cell.traffic
    pipe = es.build_program(cfg, es.make_weights(cfg, seed, dev), dev)
    pool = [es.make_batch(cfg, tr, seed, i, dev) for i in range(tr["pool"])]
    for _ in pipe.run_stream([b.stream for b in pool[:2]]):
        pass
    torch.cuda.synchronize()
    obs.clear()
    t0 = time.perf_counter()
    k = sum(1 for _ in pipe.run_stream(pool[i % len(pool)].stream
                                       for i in range(n)))
    dt = time.perf_counter() - t0
    print("card %s; %d batches in %.3f s: %.1f ms a batch, %.1f captions/s"
          % (card.strip(), k, dt, 1e3 * dt / k, k * tr["jobs"] / dt))
    print(obs.summary_line(obs.summary(), k, "batch"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
