"""Where the port's eval pipeline spends a batch, and whether run_stream
overlaps one batch's plan with the previous batch's beam, on one CUDA card.

    python3 -m vsrcic_tpu_torch.tools.profile_pipeline   # from the repo root

Builds chip_smoke.py's phase-8 pipeline (1024 jobs per batch at full width,
the fast bf16 captioner), runs two batches through run_stream to warm up
(the second allocates the pinned buffers that the stream cycles through),
then two batches through run_stream under torch.profiler, with a range
around each of the pipeline's steps (plan_dispatch, plan_finish, the recons
build, the beam dispatch, the waits for results). Prints the card's name
and power limit, the wall time, the device's busy and idle shares, device
time by kernel group, each host range with the device's busy share inside
it, where the second batch's plan ran on the device relative to the first
batch's beam, and the host's stream and device synchronisations by range.
Writes the kernel table and the Chrome trace to chiprun_out/.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANGES = ("plan_dispatch", "plan_finish", "_build_recons", "_dispatch_beam",
          "_finish_readback")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(busy, s, e):
    return sum(max(0.0, min(e, b1) - max(s, b0)) for b0, b1 in busy)


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_pipeline: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
    import chip_smoke as cs
    from profile_torch_beam import GROUPS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    pipe = cs.pipeline_world(cs.main_captioner())
    batch = cs.pipeline_batch(pipe)

    for name in RANGES:
        def ranged(*a, _fn=getattr(pipe, name), _name=name, **kw):
            with record_function(_name):
                return _fn(*a, **kw)
        setattr(pipe, name, ranged)

    list(pipe.run_stream([batch] * 2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(pipe.run_stream([batch] * 2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    # device work only: each host range also shows up on the device's
    # timeline under its own name, spanning the whole range
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in RANGES]
    busy = union([(e.time_range.start, e.time_range.end) for e in kernels])
    busy_us = sum(e - s for s, e in busy)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in RANGES]
    t_start = min([e.time_range.start for e in host]
                  + [s for s, _ in busy])
    span_us = max([e.time_range.end for e in host] + [e for _, e in busy]) \
        - t_start
    by_group = {}
    for e in kernels:
        group = next((g for frag, g in GROUPS if frag in e.name.lower()),
                     "other")
        if "sinkhorn" in e.name:
            group = "sinkhorn (hand-written)"
        by_group[group] = by_group.get(group, 0.0) + e.time_range.elapsed_us()

    print(card)
    print("two batches through run_stream: wall %.1f ms; device busy %.1f ms "
          "(%.1f%% of the profiled span %.1f ms)"
          % (1e3 * wall, busy_us / 1e3, 100 * busy_us / span_us,
             span_us / 1e3))
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print("  %-36s %9.2f ms" % (g, us / 1e3))
    print("host ranges (start ms from the first, duration, device busy "
          "share inside, syncs inside):")
    syncs = [e for e in events if e.name in SYNCS]
    rows = []
    for e in sorted(host, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        n_sync = sum(1 for x in syncs if s <= x.time_range.start < t)
        share = covered(busy, s, t) / max(t - s, 1e-9)
        rows.append(dict(name=e.name, start_ms=(s - t_start) / 1e3,
                         ms=(t - s) / 1e3, device_busy=share, syncs=n_sync))
        print("  %-18s %9.2f %9.2f ms  %5.1f%%  %d"
              % (e.name, (s - t_start) / 1e3, (t - s) / 1e3, 100 * share,
                 n_sync))
    sink = sorted(e.time_range.start for e in kernels if "sinkhorn" in e.name)
    vocab = sorted(e.time_range.end for e in kernels
                   if "vocab_tile" in e.name)
    order = {}
    if len(sink) >= 2 and len(vocab) >= 2 * cs.SEQ_LEN:
        beam1_end = vocab[cs.SEQ_LEN - 1]
        order = dict(second_plan_sinkhorn_ms=(sink[1] - t_start) / 1e3,
                     first_beam_last_vocab_ms=(beam1_end - t_start) / 1e3,
                     second_plan_before_first_beam_end=sink[1] < beam1_end)
        print("device order: batch 2's Sinkhorn at %.2f ms, batch 1's last "
              "vocab kernel ends at %.2f ms (plan 2 ran %s beam 1's end)"
              % (order["second_plan_sinkhorn_ms"],
                 order["first_beam_last_vocab_ms"],
                 "before" if order["second_plan_before_first_beam_end"]
                 else "after"))
    print("host synchronisations in the window by name: %s"
          % {n: sum(1 for x in syncs if x.name == n) for n in SYNCS})
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "profile_pipeline.json"))
    with open(os.path.join(out, "profile_pipeline.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({"card": card, "wall_ms": 1e3 * wall,
                      "device_busy_ms": busy_us / 1e3,
                      "span_ms": span_us / 1e3,
                      "groups_ms": {g: us / 1e3
                                    for g, us in by_group.items()},
                      "ranges": rows, "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
