"""Where the port's trainers spend a step, on one CUDA card.

    python3 -m vsrcic_tpu_torch.tools.profile_train              # captioner
    python3 -m vsrcic_tpu_torch.tools.profile_train --planners   # planners

Builds chip_smoke.py's phase-10 world (CaptionerConfig() widths, batch
1024, compact ids, the SCST text field and CIDEr-D), warms each trainer up
with one step, then profiles one XE step and one SCST step (fast_decode,
bf16 tables, the native CIDEr-D scorer) under torch.profiler, with a range
around each of the SCST step's parts (decode, _decode_caps, rewards,
grad_step). With --planners, phase 12's world instead: one S-SSP step
(1536 groups) and one Sinkhorn step (1536 pairs). Prints the card's name
and power limit, and for each step its wall time, the device's busy and
idle shares, its kernel count, device time by kernel group, and each host
range with the device's busy share inside it. Writes the kernel tables to
chiprun_out/.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANGES = ("decode", "_decode_caps", "rewards", "grad_step")


def profiled(fn, ranges=()):
    """fn() under torch.profiler: (wall s, busy us, kernel count,
    {group: us}, [(range, ms, device busy share)], profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from profile_torch_beam import GROUPS
    from vsrcic_tpu_torch.tools.profile_pipeline import covered, union
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in ranges]
    busy = union([(e.time_range.start, e.time_range.end) for e in kernels])
    busy_us = sum(e - s for s, e in busy)
    by_group = {}
    for e in kernels:
        group = next((g for frag, g in GROUPS if frag in e.name.lower()),
                     "other")
        by_group[group] = by_group.get(group, 0.0) + e.time_range.elapsed_us()
    rows = []
    for e in sorted((e for e in events if e.device_type == DeviceType.CPU
                     and e.name in ranges),
                    key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        rows.append((e.name, (t - s) / 1e3,
                     covered(busy, s, t) / max(t - s, 1e-9)))
    return wall, busy_us, len(kernels), by_group, rows, prof


def report(name, wall, busy_us, n_kernels, by_group, rows):
    print("%s: wall %.1f ms; device busy %.1f ms (%.1f%%), idle %.1f%%; %d "
          "kernels" % (name, 1e3 * wall, busy_us / 1e3,
                       100 * busy_us / 1e6 / wall,
                       100 - 100 * busy_us / 1e6 / wall, n_kernels))
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print("  %-36s %9.2f ms  %5.1f%% of busy" % (g, us / 1e3,
                                                   100 * us / busy_us))
    for r, ms, share in rows:
        print("  range %-14s %9.2f ms  device busy %5.1f%%"
              % (r, ms, 100 * share))
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "kernels": n_kernels,
            "groups_ms": {g: us / 1e3 for g, us in by_group.items()},
            "ranges": [{"name": r, "ms": ms, "device_busy": share}
                       for r, ms, share in rows]}


def planner_steps(cs):
    """(name, step function) of phase 12's two planner trainers, warmed
    up."""
    import torch
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.train.planners import SinkhornTrainer, SSPTrainer
    cfg = SSPConfig(dataset="coco")
    ssp = SSPTrainer(cfg, init_ssp_params(torch.Generator().manual_seed(1),
                                          cfg), lr=cs.PLAN_LR, device="cuda")
    batch = cs.ssp_world()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sink_cfg = SinkhornConfig()
    sink = SinkhornTrainer(sink_cfg, init_sinkhorn_params(
        torch.Generator().manual_seed(2), sink_cfg), lr=cs.PLAN_LR,
        device="cuda")
    pairs = cs.sinkhorn_world()
    steps = [("one S-SSP step (%d groups)" % cs.PLAN_GROUPS,
              lambda: ssp.step(*batch, gen)),
             ("one Sinkhorn step (%d pairs)" % cs.PLAN_PAIRS,
              lambda: sink.step(*pairs, n_images=cs.PLAN_IMAGES))]
    for _, step in steps:
        step()
    return steps


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
    import chip_smoke as cs
    from torch.profiler import record_function
    from vsrcic_tpu_torch.metrics.cider_native import NativeCiderPair
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.train.captioner import (CaptionerSCSTTrainer,
                                                  CaptionerXETrainer)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    out = {"card": card}
    tables = []
    print(card)
    if "--planners" in sys.argv[1:]:
        for name, step in planner_steps(cs):
            *res, prof = profiled(step)
            out[name] = report(name, *res)
            tables.append(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        return finish(out, tables, "profile_planners.txt")

    cfg = CaptionerConfig()
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    det, caps, ids, gates, groups = cs.train_world()
    tf, cider, gts = cs.text_world(caps)
    xe = CaptionerXETrainer(cfg, params, lr=cs.TRAIN_LR, device="cuda")
    xe.step(det, caps, ids, gates)
    *res, prof = profiled(lambda: xe.step(det, caps, ids, gates))
    out["xe_step"] = report("one XE step (lean)", *res)
    tables.append(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    del xe, prof
    torch.cuda.empty_cache()

    sc = CaptionerSCSTTrainer(cfg, params, tf, cider, lr=cs.TRAIN_LR,
                              fast_decode=True, table_dtype=torch.bfloat16,
                              native_cider=NativeCiderPair(cider),
                              device="cuda")
    for name in RANGES:
        def ranged(*a, _fn=getattr(sc, name), _name=name, **kw):
            with record_function(_name):
                return _fn(*a, **kw)
        setattr(sc, name, ranged)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sc.step(det, groups, gts, gen)
    *res, prof = profiled(lambda: sc.step(det, groups, gts, gen), RANGES)
    out["scst_step"] = report("one SCST step (fast_decode, bf16 tables, "
                              "native CIDEr-D)", *res)
    tables.append(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    return finish(out, tables, "profile_train.txt")


def finish(out, tables, name):
    path = os.path.join(REPO, "chiprun_out")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "w") as f:
        f.write("\n\n".join(tables))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
