#!/usr/bin/env python3
"""Where the time of the port's beam-5 decode goes, on one CUDA card.

    python3 scripts/profile_torch_beam.py

Runs chip_smoke.py's main path (bench.py shapes: batch 1024, beam 5, fused
attention, vocab top-k, bf16 tables) once to warm up and once under
torch.profiler. Prints the card's name and power limit, the batch's wall
time, the device's busy and idle shares, device time by kernel group and
the top kernels; writes the full table to chiprun_out/profile_beam.txt.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel name fragment -> group (first match wins)
GROUPS = (("fused_attention_kernel", "fused_attention (hand-written)"),
          ("vocab_tile_kernel", "vocab_topk stage 1 (hand-written)"),
          ("vocab_merge_kernel", "vocab_topk stage 2 (hand-written)"),
          ("gemm", "cuBLAS f32 products"), ("gemv", "cuBLAS f32 products"),
          ("sort", "sorts (beam select)"), ("radix", "sorts (beam select)"),
          ("index", "gathers / index"), ("gather", "gathers / index"),
          ("cat", "concat / copies"), ("copy", "concat / copies"),
          ("reduce", "reductions"))


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_beam: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cap = cs.main_captioner()
    detections, det_groups, verb_list = cs.main_inputs()

    def run():
        return cap.beam_search_v(detections, det_groups, verb_list,
                                 eos_word=3, beam_size=cs.BEAM)

    run()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memcpy/memset): a CPU op's time
    # would count its kernels a second time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_t = lambda e: e.self_device_time_total
    busy_us = sum(dev_t(e) for e in events)
    by_group = {}
    for e in events:
        name = e.key.lower()
        group = next((g for frag, g in GROUPS if frag in name), "other")
        by_group[group] = by_group.get(group, 0.0) + dev_t(e)
    print(card)
    print("batch wall %.1f ms; device busy %.1f ms (%.1f%%), idle %.1f%%"
          % (1e3 * wall, busy_us / 1e3, 100 * busy_us / 1e6 / wall,
             100 - 100 * busy_us / 1e6 / wall))
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print("  %-36s %9.2f ms  %5.1f%% of busy" % (g, us / 1e3,
                                                   100 * us / busy_us))
    print("top kernels by device time:")
    for e in sorted(events, key=lambda e: -dev_t(e))[:15]:
        print("  %9.2f ms  %6d calls  %s" % (dev_t(e) / 1e3, e.count,
                                             e.key[:90]))
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_beam.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({"card": card, "wall_ms": 1e3 * wall,
                      "device_busy_ms": busy_us / 1e3,
                      "groups_ms": {g: us / 1e3
                                    for g, us in by_group.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
