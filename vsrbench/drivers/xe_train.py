"""XE training of the captioner: back-to-back `CaptionerXETrainer.step`
calls on batches cycled from a pool made in set-up.

Traffic parameters (`traffic/<name>.json`): `batch` sequences a step;
`pool` distinct batches; `real_detections` [lo, hi] detections of an
image that are not zero (standard normal features); `caption_words`
[lo, hi] words before the EOS, padded to seq_len; `regions_per_step`
[lo, hi] region ids a step (compact ids, -1 after); `gate_shift_share`
the share of gate targets that shift; `check_steps` steps the reference
follows (set-up makes them, on distinct batches, through the window's own
call; one more step after the window is held to the reference's step
from the program's state there); the traced slice, run once the window has closed (`trace_wait`
steps, one of warm-up, then `trace_units`); `ref_block` rows a block of
the reference's gradient.

Every seed gives the same sizes; only the values differ.

End-to-end: `train_samples_per_s` (sequences of the steps that returned
in the window over the window's seconds; the window ends with the first
step that returns at or past `--seconds`), `setup_s`.
"""
from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np

from vsrbench import harness, weights
from vsrbench.harness import UNIT_SPAN
from vsrbench.reference.captioner import flatten as flat


def make_batch(cfg, tr, seed, index, device):
    """(detections (B, N, D), captions (B, T), region ids (B, T, M), gate
    targets (B, T)) on the device."""
    import torch
    c, data = cfg["captioner"], cfg["data"]
    b, t, n = tr["batch"], c["seq_len"], data["detections"]
    m, v = data["regions"], c["vocab_size"]
    g = harness.torch_gen(seed, device, 40, index)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=device)

    def between(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (rnd(*shape) * (hi - lo + 1)).long().clamp_max(hi - lo)

    real = between(tr["real_detections"], b)
    det = torch.randn((b, n, c["det_feat_size"]), generator=g, device=device)
    det.mul_((torch.arange(n, device=device)[None, :]
              < real[:, None])[..., None])
    length = between(tr["caption_words"], b)[:, None]
    pos = torch.arange(t, device=device)[None, :]
    words = 4 + (rnd(b, t) * (v - 4)).long().clamp_max(v - 5)
    caps = torch.where(pos == 0, c["bos_idx"], torch.where(
        pos <= length, words, torch.where(pos == length + 1,
                                          data["eos_word"], data["pad_word"])))
    regions = between(tr["regions_per_step"], b, t)
    ids = (rnd(b, t, m) * real[:, None, None]).long()
    ids = torch.where(torch.arange(m, device=device) < regions[..., None],
                      ids, -1)
    gates = torch.where(pos <= length + 1,
                        (rnd(b, t) < tr["gate_shift_share"]).long(), -1)
    return det, caps, ids, gates


def make_weights(cfg, seed, device):
    gen = harness.torch_gen(seed, device, 1)
    return weights.make(weights.captioner_leaves(cfg["captioner"]), gen,
                        device)


def build_program(cfg, params, device):
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.train.captioner import CaptionerXETrainer
    return CaptionerXETrainer(CaptionerConfig(**cfg["captioner"]),
                              weights.clone(params), lr=cfg["optim"]["lr"],
                              lean=cfg["program"]["lean"], device=device)


def leaf_norms(tree):
    import torch
    f = flat(tree)
    return {k: float(n) for k, n in zip(f, torch.stack(
        [v.double().norm() for v in f.values()]).tolist())}


def first_steps(trainer, pool, p0, n_steps, b1):
    """Set-up's steps: the program's losses, the parameters that each step
    after the first started from (copies), its first gradient as Adam
    holds it after one step (first moment / (1 - b1)), and the change of
    its parameters after n_steps, per leaf (norms)."""
    losses, grad, starts = [], None, [None]
    for s in range(n_steps):
        if s:
            starts.append({k: v.clone() for k, v in
                           flat(trainer.state.params).items()})
        losses.append(trainer.step(*pool[s]))
        if s == 0:
            grad = {k: v / (1 - b1) for k, v in
                    flat(trainer.state.opt_state.mu).items()}
            grad = leaf_norms(grad)
    now = flat(trainer.state.params)
    delta = leaf_norms({k: now[k] - v for k, v in flat(p0).items()})
    return {"losses": losses, "starts": starts, "grad": grad,
            "delta": delta}


def late_step(trainer, batch, b1):
    """One more step of the program once the window has closed, from its
    live state: copies of that state (parameters, moments, count), and
    the step's losses, its gradient as Adam took it (the first moment's
    change over 1 - b1) and the change of the parameters, per leaf
    (norms)."""
    st = trainer.state
    before = {"params": {k: v.clone() for k, v in flat(st.params).items()},
              "mu": {k: v.clone() for k, v in flat(st.opt_state.mu).items()},
              "nu": {k: v.clone() for k, v in flat(st.opt_state.nu).items()},
              "count": int(st.opt_state.count)}
    loss = trainer.step(*batch)
    mu, now = flat(trainer.state.opt_state.mu), flat(trainer.state.params)
    grad = leaf_norms({k: (v - b1 * before["mu"][k]) / (1 - b1)
                       for k, v in mu.items()})
    delta = leaf_norms({k: v - before["params"][k] for k, v in now.items()})
    return before, {"losses": [loss], "grad": grad, "delta": delta}


def run(cell, args, device, t_process):
    import torch
    cfg, tr = cell.config, cell.traffic
    trace = bool(args.trace)
    stages = [("start", t_process), ("imports", time.perf_counter())]
    p0 = make_weights(cfg, args.seed, device)
    stages.append(("weights", time.perf_counter()))
    trainer = build_program(cfg, p0, device)
    stages.append(("program", time.perf_counter()))
    pool = [make_batch(cfg, tr, args.seed, i, device)
            for i in range(tr["pool"])]
    stages.append(("inputs", time.perf_counter()))
    k = tr["check_steps"]
    got = first_steps(trainer, pool, p0, k, cfg["optim"]["betas"][0])
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    stages.append(("first steps", time.perf_counter()))
    rf = None
    if trace:
        from torch.profiler import record_function as rf
    spans = harness.Spans(rf)
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    steps, bad = 0, 0
    while True:
        batch = pool[(k + steps) % len(pool)]
        with spans.span(UNIT_SPAN):
            loss = trainer.step(*batch)
        steps += 1
        bad += not np.isfinite(loss[0])
        t_end = time.perf_counter()
        if t_end >= deadline:
            break
    tracer = None
    i = steps
    if trace:
        # the traced slice: further steps, once the window has closed
        tracer = harness.Tracer(device, tr["trace_wait"], tr["trace_units"])
        tracer.start()
        while not tracer.done:
            with spans.span(UNIT_SPAN):
                trainer.step(*pool[(k + i) % len(pool)])
            i += 1
            tracer.step(dict)
        tracer.stop()
    sync()
    card = harness.card_info(device)
    setup_s = t0 - t_process
    window_s = t_end - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    result = {"attempted": steps * tr["batch"], "failed": bad * tr["batch"],
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": card["kind"],
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if not trace:
        values = {"train_samples_per_s": steps * tr["batch"] / window_s,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        print("vsrbench: %d steps of %d sequences in %.3f s"
              % (steps, tr["batch"], window_s), file=sys.stderr)
    else:
        sl = harness.Slice(tracer, (UNIT_SPAN,))
        ctx = SimpleNamespace(config=cfg, traffic=tr, slice=sl, spans=spans,
                              window=(t0, t_end), window_s=window_s,
                              units=steps, card=card)
        result["metrics"] = harness.read_metrics(cell, ctx)
        result["device"].update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["breakdown"] = sl.breakdown()
    result["card"] = {"name": card["kind"],
                      "power_limit_w": card["power_limit_w"]}
    print("vsrbench: card %s, power limit %s W; setup_s %.3f (%s)"
          % (card["kind"], card["power_limit_w"], setup_s,
             harness.stage_line(stages)), file=sys.stderr)
    late_batch = pool[(k + i) % len(pool)]
    before, late = late_step(trainer, late_batch, cfg["optim"]["betas"][0])
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cfg, tr, p0, pool, got, (before, late_batch, late),
                   cell.limits)
    result["correct"] = (not bad and all(
        c["value"] <= c["limit"] for c in checks.values()))
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "card")
    return {k: result[k] for k in order if k in result}, checks


def reference_steps(cfg, tr, p0, pool, n_steps):
    """The reference's losses, the parameters that each step after the
    first started from, its first gradient and the change after n_steps,
    per leaf (norms), from the same initial weights and batches."""
    import torch
    from vsrbench.reference import captioner as rc
    opt = cfg["optim"]
    params = {k: v.clone() for k, v in rc.flatten(p0).items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad, starts = [], None, [None]
    for s in range(n_steps):
        if s:
            starts.append(params)
        det, caps, ids, gates = pool[s]
        lw, lg, grads = rc.xe_grads(rc.unflatten(params), cfg["captioner"],
                                    det, caps, ids, gates, tr["ref_block"])
        losses.append((lw + 4.0 * lg, lw, lg))
        if s == 0:
            grad = leaf_norms(grads)
        params, m, v2 = rc.adam_step(params, grads, m, v2, s + 1, opt["lr"],
                                     opt["betas"][0], opt["betas"][1],
                                     opt["eps"])
    delta = leaf_norms({k: params[k] - v for k, v in rc.flatten(p0).items()})
    return {"losses": losses, "starts": starts, "grad": grad,
            "delta": delta}


def losses_at(cfg, tr, side, pool, ref):
    """The reference's losses of set-up's steps at the parameters that each
    step of `side` (the program's `first_steps`, or a stand-in's
    `reference_steps`) started from: at the first step the reference's
    own, as both start from the seed's weights; after it, the reference's
    loss at `side`'s parameters. Adam's first steps move every element by
    about lr whatever the size of its gradient, so two sound float32 runs
    part by rounding within one step, and a later step's loss is judged
    at the parameters it was taken at."""
    from vsrbench.reference import captioner as rc
    out = [ref["losses"][0]]
    for s in range(1, len(side["losses"])):
        lw, lg = rc.xe_losses(rc.unflatten(side["starts"][s]),
                              cfg["captioner"], *pool[s], tr["ref_block"])
        out.append((lw + 4.0 * lg, lw, lg))
    return out


def reference_late(cfg, tr, before, batch):
    """The reference's step from the program's state `before` (see
    `late_step`): losses, gradient and change, per leaf (norms)."""
    from vsrbench.reference import captioner as rc
    opt = cfg["optim"]
    p = before["params"]
    lw, lg, grads = rc.xe_grads(rc.unflatten(p), cfg["captioner"], *batch,
                                tr["ref_block"])
    new, _, _ = rc.adam_step(p, grads, before["mu"], before["nu"],
                             before["count"] + 1, opt["lr"],
                             opt["betas"][0], opt["betas"][1], opt["eps"])
    return {"losses": [(lw + 4.0 * lg, lw, lg)], "grad": leaf_norms(grads),
            "delta": leaf_norms({k: new[k] - v for k, v in p.items()})}


def readings(cfg, got, ref):
    """The numbers compared: the worst relative gap of each step's word and
    gate losses (`ref`'s losses taken at the parameters of `got`'s step,
    see `losses_at`); the worst leaf's gap of first-gradient norms and of
    change norms, each over the larger of that leaf's reference norm and
    the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's move under Adam by round-off alone and
    are left out of the change."""
    loss, at = max((abs(a - b) / max(abs(b), 1e-12),
                    "step %d %s %.9g vs %.9g" % (s, part, a, b))
                   for s, (ga, ra) in enumerate(zip(got["losses"],
                                                    ref["losses"]))
                   for part, a, b in zip(("word", "gate"), ga[1:], ra[1:]))
    med_g = float(np.median(list(ref["grad"].values())))
    grad, grad_at = max((abs(got["grad"][k] - r) / max(r, med_g), k)
                        for k, r in ref["grad"].items())
    kept = [k for k, r in ref["grad"].items() if r >= 1e-3 * med_g]
    med_d = float(np.median([ref["delta"][k] for k in kept]))
    delta, delta_at = max((abs(got["delta"][k] - ref["delta"][k])
                           / max(ref["delta"][k], med_d), k) for k in kept)
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": delta,
            "loss_at": at, "grad_at": grad_at, "update_at": delta_at,
            "left_out": sorted(set(ref["grad"]) - set(kept))}


NUMBERS = ("loss_gap", "grad_gap", "update_gap")


def worst_of(*readings_):
    return {k: max(r[k] for r in readings_) for k in NUMBERS}


def judge(cfg, tr, p0, pool, got, late, limits):
    """Set-up's steps from the initial weights, and the step after the
    window from the program's own state (`late`: the state before it, its
    batch and the program's readings), each against the reference's; the
    worse of the two under each number."""
    before, batch, got_late = late
    ref = reference_steps(cfg, tr, p0, pool, tr["check_steps"])
    ref["losses"] = losses_at(cfg, tr, got, pool, ref)
    r = {"setup": readings(cfg, got, ref),
         "late": readings(cfg, got_late, reference_late(cfg, tr, before,
                                                        batch))}
    for when, what in (("setup", "set-up's steps"),
                       ("late", "the step after the window")):
        print("vsrbench: %s: %s (widest loss gap at %s; worst leaves: "
              "gradient %s, change %s); leaves left out of the change "
              "(reference gradient under a thousandth of the median "
              "leaf's): %s"
              % (what, ", ".join("%s %.3e" % (k, r[when][k])
                                 for k in NUMBERS), r[when]["loss_at"],
                 r[when]["grad_at"], r[when]["update_at"],
                 ", ".join(r[when]["left_out"]) or "none"), file=sys.stderr)
    worst = worst_of(r["setup"], r["late"])
    return {k: {"value": float(worst[k]), "limit": limits[k]}
            for k in NUMBERS}
