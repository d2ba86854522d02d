"""What the program's span recorder costs a cell's rate, in one process.

    python3 -m vsrbench.span_ab --cell vsr-coco.stream-b512 [--seed N]
        [--pairs 40] [--units 4]

Builds the cell's program, weights and inputs as its driver does from
`--seed`, warms them up, then runs `--pairs` pairs of blocks of `--units`
batches or steps. The program's recorder
(`vsrcic_tpu_torch.utils.observability.RECORDER`) is on in one block of a
pair and off in the other, which comes first drawn from the seed. Each
block first runs one unit untimed, since a streamed batch's plan was
dispatched in the unit before it; then each unit is timed on the host
clock: an XE step ends in its losses' read-back, a streamed batch in its
words'.

Python's collector runs a full (generation 2) collection every so many
units, a pause of 100-300 ms that lands in either mode and dwarfs the
spans' cost. The units it fell in are kept in the means "with_gc" and
left out of the rest; their pauses are listed.

Prints one JSON line: mean ms a unit in each mode, with and without those
units; the pairs' relative rate, on against off (off's mean unit time over
on's, less 1; negative where the recorder slows the unit), its mean, its
standard error and quartiles; the spans a unit; the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import random
import statistics
import time

from vsrbench import harness, layout


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cell_units(cell, seed, dev):
    """(run one unit, its items, the unit's name) of `cell`'s program on
    `dev`, built as its driver builds it and warmed up."""
    import torch
    from vsrbench.drivers import eval_stream, xe_train
    cfg, tr = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tr["driver"] == "xe_train":
        trainer = xe_train.build_program(
            cfg, xe_train.make_weights(cfg, seed, dev), dev)
        pool = [xe_train.make_batch(cfg, tr, seed, i, dev)
                for i in range(tr["pool"])]
        steps = iter(range(10 ** 9))

        def unit():
            trainer.step(*pool[next(steps) % len(pool)])
        items, what = tr["batch"], "step"
    else:
        pipe = eval_stream.build_program(
            cfg, eval_stream.make_weights(cfg, seed, dev), dev)
        pool = [eval_stream.make_batch(cfg, tr, seed, i, dev)
                for i in range(tr["pool"])]

        def feed():
            i = 0
            while True:
                yield pool[i % len(pool)].stream
                i += 1
        stream = pipe.run_stream(feed())

        def unit():
            next(stream)
        items, what = tr["jobs"], "batch"
    for _ in range(4):
        unit()
    sync(dev)
    return unit, items, what


def compare(blocks):
    """The arithmetic of the A/B over `blocks`, a list of pairs, each
    {"on": [(seconds, gc pause or None), ...], "off": [...]}."""
    def mean_ms(mode, with_gc):
        v = [t for p in blocks for t, g in p[mode] if with_gc or g is None]
        return 1e3 * statistics.mean(v) if v else None

    rel = []
    for p in blocks:
        on = [t for t, g in p["on"] if g is None]
        off = [t for t, g in p["off"] if g is None]
        if on and off:
            rel.append(statistics.mean(off) / statistics.mean(on) - 1.0)
    out = {"ms_a_unit": {m: mean_ms(m, False) for m in ("on", "off")},
           "ms_a_unit_with_gc": {m: mean_ms(m, True) for m in ("on", "off")},
           "units": {m: sum(g is None for p in blocks for _, g in p[m])
                     for m in ("on", "off")},
           "gc_pauses_ms": {m: [1e3 * g for p in blocks for _, g in p[m]
                                if g is not None] for m in ("on", "off")},
           "pairs": len(rel), "pair_rel": rel}
    if len(rel) >= 2:
        out["pair_rel_mean"] = statistics.mean(rel)
        out["pair_rel_se"] = statistics.stdev(rel) / len(rel) ** 0.5
        out["pair_rel_quartiles"] = statistics.quantiles(rel, n=4)
    return out


def ab(unit, rec, pairs, units, seed, dev):
    """Run the pairs of blocks; the recorder `rec` is left on."""
    rng = random.Random(seed)
    pause, began = [None], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        elif info["generation"] == 2:
            pause[0] = (pause[0] or 0.0) + time.perf_counter() - began[0]

    blocks, spans = [], 0
    gc.callbacks.append(on_gc)
    try:
        for _ in range(pairs):
            order = ["on", "off"]
            rng.shuffle(order)
            pair = {}
            for mode in order:
                rec.enabled = mode == "on"
                rec.clear()
                unit()
                sync(dev)
                times = []
                for _ in range(units):
                    pause[0] = None
                    t0 = time.perf_counter()
                    unit()
                    times.append((time.perf_counter() - t0, pause[0]))
                sync(dev)
                pair[mode] = times
                if mode == "on":
                    spans = len(rec.closed()) / (units + 1)
            blocks.append(pair)
    finally:
        gc.callbacks.remove(on_gc)
        rec.enabled = True
        rec.clear()
    return blocks, spans


def main(argv=None):
    import torch
    from vsrcic_tpu_torch.utils import observability as obs
    ap = argparse.ArgumentParser(prog="span_ab")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=4300000001)
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--units", type=int, default=4)
    args = ap.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    unit, items, what = cell_units(layout.cell(args.cell), args.seed, dev)
    blocks, spans = ab(unit, obs.RECORDER, args.pairs, args.units,
                       args.seed, dev)
    out = compare(blocks)
    out["rate"] = {m: items / (v / 1e3) if v else None
                   for m, v in out["ms_a_unit"].items()}
    print(json.dumps(dict(out, cell=args.cell, seed=args.seed, unit=what,
                          units_a_block=args.units, spans_a_unit=spans,
                          card=harness.card_info(dev))))


if __name__ == "__main__":
    main()
