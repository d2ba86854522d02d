#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vsrcic_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --fused      # phases 1-2 and the fused check
    python3 chip_smoke.py --memcheck   # phases 1-2 and the memcheck (3m)
    python3 chip_smoke.py --sinkhorn   # phases 1-2 and the Sinkhorn check
    python3 chip_smoke.py --pipeline   # phases 1-2 and 8
    python3 chip_smoke.py --train      # phases 1-2 and 9-10
    python3 chip_smoke.py --planners   # phases 1-2 and 11-12
    python3 chip_smoke.py --eval       # phases 1-2 and 13
    python3 chip_smoke.py --train-cli  # phases 1-2 and 14
    python3 chip_smoke.py --parallel   # phases 1-2 and 15
    python3 chip_smoke.py --vocab-bf16 # phases 1-2, 3's vocab checks, 5-5d
                                       # (every vocab route)

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the TF32 settings
     (both off: the JAX reference runs its f32 products at 'highest');
  2. build the kernels from vsrcic_tpu_torch/csrc/ and report the build time
     and what ptxas reports (registers, shared memory, spills), the checked
     build (phase 3m's) compiling beside it; build the
     native CIDEr-D scorer (csrc/cider_scorer.cpp, host C++ compiler) and
     the packed-store reader (csrc/packed_reader.cpp), the reader held to
     its numpy version;
  3. hold each kernel against its plain PyTorch version on the card: at the
     full-width shapes of the path, at ragged shapes, on the vocab tie cases
     and, for the Sinkhorn kernel, at every (S, n) of SINK_CASE_S x
     SINK_CASE_N (the boundaries of its packing); time the kernel, its plain
     version and, where one PyTorch call computes the same function, that
     call. The Sinkhorn kernel must also give the same bits as its
     arithmetic replayed step by step in PyTorch; a few microseconds long,
     it is timed with the stream held while its launches are enqueued, and
     by the profiler. The fused attention kernel is also held to its plain
     version on runs of rows sharing a group (across its runs and
     clusters), M 1 and 33, and rows whose item or ctrl is out of range
     (NaN, the neighbours exact), and timed at its four path shapes: the
     beam, SCST's decode, the eval CLI's first step and the SCST train
     CLI's 100 rows (held stream, beside an empty kernel's time), and on
     f32 tables at the beam's and the eval CLI's shapes. The vocab
     head's f32 product is held on every table layout the facade makes
     (padded to a pitch of V rounded up to 8, an f32 table's planes made
     once) and contiguous: "split9" (f32 h2 and table: nine bf16 plane
     products), "split_w" (bf16 h2, f32 table: three), "split" (f32 h2,
     bf16 table: three) wherever TMA can read W_t, the SGEMM only where it
     cannot; the split pass gives split_bf16x3_plain's planes bit for bit
     (every kind of entry, ragged R, unaligned; W_t's rows too), each
     route holds the plain version on the tie cases (ids exact), at ragged
     R and V and at full width (V 10000 and, padded, 9999; its worst error
     printed), each check asserting its route by the launch counts; timed
     at the beam's shape beside its bound (its bf16 passes over the tensor
     cores' rate) and the CUDA cores' f32 bound, the SGEMM on the same
     values through an unaligned view, the library trio on the bf16 and
     the f32 table, and the split pass alone. The vocab
     head's bf16-operand kernel (bf16 h2 and table, tensor cores) is held
     to its plain version on the tie cases (ids exact), at ragged shapes
     and at full width (ids equal save near ties), each check asserting
     its route (TMA or mma.sync) by the launch counts, and timed beside
     its tensor-core bound, a cuBLAS bf16 product + topk + logsumexp and
     the product alone, split by the profiler into its two stages, at k 5
     and k 1. Every vocab route is held to its plain version on non-finite
     logits (0/0 rows made on the card, +-inf products, an all -inf row, a
     NaN column, a +inf bias; an f32 table's routes to vocab_planes_plain,
     whose infinite entries meet zero planes as the kernel's do): NaN and
     +-inf where it has them, ids exact on those rows, none outside [0, V);
     the captioner facade on an out_fc table with a -inf weight (bf16 and
     f32 tables, the beam's shape) reads the table as non-finite and sends
     its f32 h2 to the SGEMM, one launch and no split pass, with the plain
     version's +-inf, NaN and ids, timed beside the CUDA cores' bound;
 3m. the memory check (vsrcic_tpu_torch/tools/memcheck.py): the checked
     build (csrc/check.cuh: every access of every kernel tested against the
     bound its arguments imply) over the sweep of every launch plan, on
     guarded buffers: every fused cluster size in both copy modes, every
     vocab route, every Sinkhorn (n, S); the beam's fused call and each
     vocab route's full-width call 200 times. One line per CUDA kernel
     (cases, launches, faults, guard breaches, changed inputs); any
     non-zero count fails the run. Then each kernel at its main path's
     shape on the default and the checked build, held stream;
  4. replay the beam's golden fixtures (JAX results) through the kernel
     path: golden_beam.npz, and golden_beam_bf16.npz's four paths
     (VSRCIC_VOCAB_LHS_BF16=1 on bf16 and f32 tables, decode_dtype=bfloat16
     strict and fast);
  5. drive the beam, `ControllableCaptioner.beam_search_v` at the bench.py
     shapes (batch 1024, beam 5, fused attention, vocab top-k, bf16
     tables): one warm-up and three timed batches, with every kernel's launch
     count reset just before and read just after; every vocab launch on the
     split route, after its split pass (20 of 20 a batch); its captions
     (each item's best beam) equal a checked run's save vocab near ties
     (every vocab call held to its plain version, the plain result going
     on);
 5b. the same beam under VSRCIC_VOCAB_LHS_BF16=1 (the vocab head's bf16
     kernel): one warm-up and three timed batches, 20 bf16 launches a
     batch, all on the TMA route; its captions (each item's best beam) equal a checked run's
     save vocab near ties (every kernel call held to its plain version,
     the vocab op's plain result going on); the share of phase 5's
     captions it keeps;
 5c. the same beam with decode_dtype=torch.bfloat16, strict (no kernel)
     and fast: one warm-up and three timed batches each, every beam
     valid, the share of phase 5's captions each keeps;
 5d. the same beam on f32 tables (table_dtype None): one warm-up and three
     timed batches, every vocab launch on the nine-plane route (20 of 20 a
     batch), its captions equal a checked run's save vocab near ties and
     >= 0.99 of them the plain path's; then one batch under
     VSRCIC_VOCAB_LHS_BF16=1, every vocab launch on "split_w";
  6. run phase 5's batch through the plain versions on the card and
     compare;
  7. replay the eval pipeline's golden fixture (JAX plans and words) through
     the kernels, strict and fast captioner;
  8. drive the eval pipeline, `EvalPipeline.run_stream` and `run_batch`, at
     full width (scripts/bench_pipeline.py's jobs, 1024 per batch: planner
     hidden 512 with 2662 verbs, the 2352-d Sinkhorn net, the phase-5
     captioner): one warm-up and three timed batches through run_stream and
     one through run_batch, each with the launch counts reset just before
     and read just after (every vocab launch on the split route); the plan and beam times of one batch; the same
     batch through the plain versions on the card, compared;
  9. replay the trainers' golden fixture (JAX losses, gradients and greedy
     words) on the card: the XE trainer's step-1 gradients and three
     losses, the SCST loss and gradients of a given trajectory, and greedy
     words strict and through the fused kernel;
 10. drive both trainers at full width (the CLI's CaptionerConfig(), 100
     detections, compact ids (B, 20, 20), batch 1024): XE (lean) and SCST
     (fast_decode, bf16 tables, baseline "step"), one warm-up and three
     timed steps each, launch counts reset just before and read just after;
     XE's loss must fall over five steps on one batch; SCST rewards one
     step's captions with the native CIDEr-D scorer and with the Python
     one (within 1e-9, each scorer and the tokenizer timed alone), then
     steps with the native one; SCST's decode, reward and grad times of one
     step; its greedy words through the kernel against the plain version's;
 11. replay the planner trainers' golden fixture (JAX losses, gradient
     samples, beam sequences, assignments) on the card, the Sinkhorn
     trainer's loss through the kernel;
 12. drive both planner trainers at full width: S-SSP (SSPConfig(), 1536
     verb groups per step, dropout 0.1) and Sinkhorn (SinkhornConfig(),
     1536 pairs per step, 'images' over 1024), one warm-up and five timed
     steps each, launch counts reset just before and read just after; the
     losses must fall; the Sinkhorn trainer's gradients through the kernel
     against those through the plain version;
 13. the eval CLI, `python -m vsrcic_tpu_torch.cli.eval`, called in this
     process: (a) replay its golden fixture (tiny checkpoints and the JAX
     CLI's dumps and metric lines, COCO and Flickr): strict flags exact,
     the fast flags (--fused --vocab_topk --bf16_tables) exact against
     JAX's Pallas kernels; (b) at the CLI's default widths on synthetic
     COCO from seeded npz checkpoints, 1024 captions in two batches, four
     times: no flag (strict), checked (the fast flags, every kernel call
     held to its plain version on the same inputs, the plain result going
     on), --fused --vocab_topk (f32 tables) and the fast flags; launch
     counts reset just before each run and read just after (the vocab op
     on the split routes of the padded V 30 tables, no SGEMM launch), the
     fused kernel's item/ctrl watched for writes; the fast run's captions must
     equal the checked run's save for vocab near ties, and keep
     F32_KERNELS_BAR / BF16_TABLES_BAR of the strict run's; each kernel
     timed on the fast run's first inputs; the host's field time per
     caption; then a short Flickr --det --gt run with the fast flags;
 14. the train CLIs, `python -m vsrcic_tpu_torch.cli.train`,
     `.train_region_sort` and `.train_sinkhorn`, called in this process
     with --log_dir: (a) replay their golden fixture (the JAX CLIs' runs
     at tiny widths from shared initial checkpoints): XE's and the
     Sinkhorn CLI's (COCO and Flickr) per-step losses within rtol 1e-4,
     saved weights within rtol 1e-4 / atol 1e-6, XE's validation lines
     equal; (b) at the CLIs' default widths on synthetic COCO: XE at
     batch 100 for 5 steps and one validation pass (its first staged
     batch held to the host's arrays bit for bit), SCST --fast_decode
     from that checkpoint (2 checked steps, every fused call held to its
     plain version and item/ctrl watched, then 5 steps), S-SSP and
     Sinkhorn (2 checked steps, then 5) at their default batches, then
     the eval CLI's fast flags from the three checkpoints on 64 test
     captions; launch counts reset before each CLI and read after; per-
     step times from the journal's `t` deltas, first step excluded;
     every loss finite; the fused and Sinkhorn kernels timed on the first
     inputs the train CLIs gave them;
 15. data parallelism (`vsrcic_tpu_torch.parallel`), with every count that
     can be made not to divide by 2 made so (1023 pipeline jobs, 1537
     S-SSP groups, 1537 Sinkhorn pairs): (a) NCCL at world 1 in this
     process: `sharded_beam_search_v` at bench.py's shapes,
     `EvalPipeline(mesh=...)`, XE and SCST (fast decode, native CIDEr-D)
     at batch 1024, S-SSP and Sinkhorn, two steps each, give the
     single-device results bit for bit, and the four train CLIs and the
     eval CLI (fast flags) at `--data_parallel 1` give the `0` runs'
     losses, lines and dumps; (b) gloo on two ranks sharing the card
     (explicit devices cuda:0, cuda:0; NCCL refuses two ranks on one card),
     one spawn: each rank's beam block equals the single-device program on
     that block bit for bit, the gathered beam and pipeline keep at least
     P15_CAPTION_SHARE of the single-device batch's captions (the rest are
     counted: a block's products round otherwise), the trainers' losses
     are within rtol 1e-4 of the single-device runs' and their weights as
     P15_PARAM_SHARE says (SCST's grad step on a single-device trajectory;
     its whole steps sample each rank's own stream), every rank's weights
     have one checksum; per-rank launches (fused and vocab top-k 20 a beam
     batch, the pipeline's 1/20/20, SCST 40 a step, Sinkhorn 1 a step),
     and every fused launch's item/ctrl watched for writes. A rank that
     fails fails the phase with its traceback.

Prints the kernels' JSON line, then, last, the device JSON line. Details go
to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
# and dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12

# bench.py:43-49 shapes
BATCH, BEAM, SEQ_LEN, VOCAB = 1024, 5, 20, 10000
DET, EMB, RNN, ATT = 2048, 1000, 1000, 512
L_GROUPS, M_REGIONS, N_DET = 10, 20, 50
M_PAD = 24   # the eval pipeline hands the tables M-padded (bench.py:73-79)
ROWS = BATCH * BEAM
# the eval pipeline's Sinkhorn call at scripts/bench_pipeline.py's jobs:
# 1536 ambiguous (verb, role) pairs per batch of 1024, n 10, 20 iterations
SINK_S, SINK_N, SINK_ITERS, SINK_TAU = 1536, 10, 20, 0.1
# the Sinkhorn kernel's checked shapes: n at the edges of its packing (32 // n
# matrices per warp up to 16, one up to 32, one block per matrix above) and
# S at the edges of a warp's group and of the pipeline's batch
SINK_CASE_N = (1, 2, 3, 10, 11, 16, 17, 31, 32, 33, 64, 241)
SINK_CASE_S = (1, 2, 3, 7, 1535, 1536, 1537)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def held_ms(fn, iters=100, warmup=3, hold_cycles=50_000_000):
    """Mean device time of fn() over `iters` launches enqueued while a spin
    kernel (torch.cuda._sleep, ~25 ms) holds the stream, so that the events
    time the launches back to back on the device, not the host's launch
    interval. Returns (device ms per call, the host's ms per call to
    enqueue); raises if the hold ended before the enqueue did."""
    import torch
    for _ in range(warmup):
        fn()
    held = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held.record()
    torch.cuda._sleep(hold_cycles)
    start.record()
    t1 = time.perf_counter()
    for _ in range(iters):
        fn()
    t2 = time.perf_counter()
    end.record()
    end.synchronize()
    hold_ms = held.elapsed_time(start)
    if 1e3 * (t2 - t0) >= hold_ms:
        raise AssertionError("the stream's hold (%.3f ms) ended before the "
                             "host had enqueued %d launches (%.3f ms)"
                             % (hold_ms, iters, 1e3 * (t2 - t0)))
    return start.elapsed_time(end) / iters, 1e3 * (t2 - t1) / iters


def profiled_ms(fn, name, iters=100):
    """Device time per call of the kernels whose name holds `name`, under
    torch.profiler over `iters` calls: (ms per call, kernels counted), or
    (None, 0) when the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if name in e.key and e.self_device_time_total > 0]
    if not events:
        return None, 0
    us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / iters, sum(e.count for e in events)


def kernel_split(fn, match, iters=50):
    """Device ms per call of each kernel whose name holds `match`, under
    torch.profiler over `iters` calls of fn: {short name: ms}, empty when
    the trace shows no device time (then CUDA events must do)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    import re
    out = {}
    for e in prof.key_averages():
        found = re.search(r"\b%s\w*" % match, e.key)
        if found and e.self_device_time_total > 0:
            name = found.group(0)
            out[name] = out.get(name, 0.0) + (
                e.self_device_time_total / 1e3 / iters)
    return out


def fmt_split(split):
    return ", ".join("%s %.4f ms" % kv for kv in sorted(split.items())) or (
        "no device time in the trace")


def max_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def check_packed_reader(report):
    """Build the packed-store reader (csrc/packed_reader.cpp, host C++
    compiler) and hold one gather against its numpy version."""
    import numpy as np
    from vsrcic_tpu_torch.data import native_reader
    from vsrcic_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.host_library("packed_reader")
    report["packed_reader_build_seconds"] = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    src = rng.rand(4000, 2048).astype(np.float32)
    starts = list(range(0, 3900, 37))
    counts = [int(c) for c in rng.randint(0, 120, len(starts))]
    got = native_reader.fill_padded_batch(src, starts, counts, 100)
    want = native_reader.fill_padded_batch_plain(src, starts, counts, 100)
    if not np.array_equal(got, want):
        raise AssertionError("the packed-store reader disagrees with its "
                             "numpy version")
    log("    packed-store reader (csrc/packed_reader.cpp, c++) built in "
        "%.1f s; a %d-image gather equals its numpy version"
        % (report["packed_reader_build_seconds"], len(starts)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_inputs(gen, rows, b, m, d, a, table, n_real=None, beam=BEAM,
                 l=L_GROUPS, ctrl_by="row"):
    """Phase 3's fused attention inputs. ctrl_by "row": a random ctrl per
    row; "item": one per item, shared by its beams (consecutive rows on
    one group, as the eval CLI's first step gives); "one": every row on
    group (0, 0)."""
    import torch
    dev = "cuda"
    det = torch.rand((b, l, m, d), generator=gen, device=dev)
    det[:, :, n_real or m:] = 0.0           # padded regions are all zero
    det[:, :, 0, :] *= (torch.rand((b, l, 1), generator=gen,
                                   device=dev) < 0.9)  # some empty regions
    proj = torch.randn((b, l, m, a), generator=gen, device=dev)
    item = (torch.arange(rows, device=dev) // beam).clamp(max=b - 1)
    if ctrl_by == "row":
        ctrl = torch.randint(0, l, (rows,), generator=gen, device=dev)
    elif ctrl_by == "item":
        ctrl = torch.randint(0, l, (b,), generator=gen, device=dev)[item]
    else:
        item = torch.zeros_like(item)
        ctrl = torch.zeros_like(item)
    ha = torch.randn((rows, a), generator=gen, device=dev)
    sent_w = torch.randn((rows, 1), generator=gen, device=dev)
    sent_mask = (torch.rand((rows, 1), generator=gen, device=dev)
                 < 0.95).float()
    fc = torch.randn((rows, d), generator=gen, device=dev)
    att_a = torch.randn((a,), generator=gen, device=dev) / a ** 0.5
    return (item.int(), ctrl.int(), ha, sent_w, sent_mask, fc, att_a,
            det.to(table).contiguous(), proj.to(table).contiguous())


def fused_bound(args):
    """Least time for one call: each needed input byte read once (the
    distinct (item, ctrl) groups this call touches), each output byte
    written once, over the HBM rate; or its f32 flops over the f32 rate."""
    import torch
    item, ctrl, ha, sent_w, sent_mask, fc, att_a, det, proj = args
    rows, a = ha.shape
    _, l, m, d = det.shape
    groups = int(torch.unique(item.long() * l + ctrl.long()).numel())
    tb = det.element_size()
    nbytes = (groups * m * (d + a) * tb + rows * (a + d + 2 + 2) * 4
              + a * 4 + rows * (d + 1) * 4)
    flops = rows * m * (d + 4 * a + 2 * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", groups)


# phase 3's fused attention cases: (name, rows, B, M, D, A, n_real, beam, L,
# ctrl_by), each on bf16 and f32 tables. "full": the beam's rows (M 20 and
# the pipeline's padded 24); "ragged": D and A off the 16-byte rows of the
# bulk copies; "beam1": the trainers' decodes; "shared": the eval CLI's
# beams on one group, in runs that cross run and cluster boundaries (37
# rows of beam 5 and 5120 of beam 3); "one": every row on one group; "m1" /
# "m33": one region and more regions than a warp's lanes; "ragged_run": M
# 33 with D and A ragged in runs of beam 7
FUSED_CASES = (
    ("full", ROWS, BATCH, M_REGIONS, DET, ATT, M_REGIONS, BEAM, L_GROUPS,
     "row"),
    ("full", ROWS, BATCH, M_PAD, DET, ATT, M_REGIONS, BEAM, L_GROUPS, "row"),
    ("ragged", 37, 9, 5, 100, 36, 4, BEAM, L_GROUPS, "row"),
    ("ragged", 13, 4, 7, 130, 50, 7, BEAM, L_GROUPS, "row"),
    ("beam1", BATCH, BATCH, M_REGIONS, DET, ATT, M_REGIONS, 1, SEQ_LEN,
     "row"),
    ("beam1", 100, 100, M_REGIONS, DET, ATT, M_REGIONS, 1, SEQ_LEN, "row"),
    ("beam1", 37, 37, M_REGIONS, DET, ATT, M_REGIONS, 1, SEQ_LEN, "row"),
    ("beam1", 1, 1, M_REGIONS, DET, ATT, M_REGIONS, 1, SEQ_LEN, "row"),
    ("shared", 2560, 512, M_REGIONS, DET, ATT, M_REGIONS, BEAM, L_GROUPS,
     "item"),
    ("shared", 37, 8, M_PAD, DET, ATT, M_REGIONS, BEAM, L_GROUPS, "item"),
    ("shared", ROWS, 1707, M_PAD, DET, ATT, M_REGIONS, 3, L_GROUPS, "item"),
    ("one", 777, 3, M_REGIONS, DET, ATT, M_REGIONS, BEAM, L_GROUPS, "one"),
    ("m1", 64, 13, 1, DET, ATT, 1, BEAM, L_GROUPS, "item"),
    ("m33", 300, 60, 33, DET, ATT, 33, BEAM, L_GROUPS, "item"),
    ("ragged_run", 300, 43, 33, 1000, 100, 30, 7, L_GROUPS, "item"),
    ("ragged_run", 11, 2, 3, 7, 3, 3, 7, L_GROUPS, "item"),
)
# rows of the "bad" cases whose item or ctrl is out of range, inside runs of
# shared groups: NaN outputs, the neighbours exact
FUSED_BAD_ROWS = (0, 2, 3, 17, 18, 19, 36)


def fused_case(gen, name, rows, b, m, d, a, table, n_real, beam, l, ctrl_by,
               bad=()):
    """Run the kernel once on a case and hold it to its plain version at
    rtol / atol 1e-5: item / ctrl unchanged, rows in `bad` (whose item or
    ctrl is set out of range) NaN, every other row exact. Returns (the
    inputs, max abs error)."""
    import torch
    from vsrcic_tpu_torch.ops.fused_attention import (
        fused_group_attention as kern, fused_group_attention_plain as plain)
    args = fused_inputs(gen, rows, b, m, d, a, table, n_real, beam, l,
                        ctrl_by)
    ok_rows = torch.ones(rows, dtype=torch.bool, device="cuda")
    run_args = args
    if bad:
        bad_t = torch.tensor(bad, device="cuda")
        item, ctrl = args[0].clone(), args[1].clone()
        item[bad_t[0::3]] = b
        ctrl[bad_t[1::3]] = l
        item[bad_t[2::3]] = -1
        ok_rows[bad_t] = False
        run_args = (item, ctrl) + tuple(args[2:])
    index = [t.clone() for t in run_args[:2]]
    got = kern(*run_args)
    torch.cuda.synchronize()
    # the plain version gathers with item/ctrl; a kernel that wrote them
    # would show up there as an out-of-range index, not as a mismatch
    if not all(torch.equal(t, c) for t, c in zip(run_args[:2], index)):
        raise AssertionError("fused attention changed its item/ctrl "
                             "inputs (%s)" % name)
    want = plain(*args)
    if bad and not all(bool(torch.isnan(g[~ok_rows]).all()) for g in got):
        raise AssertionError("fused attention: an out-of-range row is not "
                             "NaN (%s)" % name)
    got = [g[ok_rows] for g in got]
    want = [w[ok_rows] for w in want]
    err = max_err(got, want)
    log("  fused_attention %-10s rows=%d B=%d L=%d M=%d D=%d A=%d %s%s: "
        "max_abs_err=%.3g" % (name, rows, b, l, m, d, a,
                              str(table).split(".")[1],
                              " (%d rows out of range)" % len(bad)
                              if bad else "", err))
    if not all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
               for g, w in zip(got, want)):
        raise AssertionError("fused attention disagrees with its plain "
                             "version beyond 1e-5 (%s)" % name)
    return args, err


def check_fused(gen, report):
    """Phase 3 for fused attention: every case of FUSED_CASES on both
    tables, the out-of-range rows, then the kernel timed at the four shapes
    of its paths (the beam, SCST's decode, the eval CLI's first step, the
    SCST train CLI's 100 rows on a held stream beside an empty kernel's)."""
    import torch
    from vsrcic_tpu_torch.ops.fused_attention import (
        fused_group_attention as kern, fused_group_attention_plain as plain)
    worst = 0.0
    timed, timed_f32 = {}, {}
    for case in FUSED_CASES:
        for table in (torch.bfloat16, torch.float32):
            args, err = fused_case(gen, case[0], *case[1:6], table,
                                   *case[6:])
            worst = max(worst, err)
            (timed if table == torch.bfloat16 else timed_f32).setdefault(
                case[:3] + (case[3],), args)
    for table in (torch.bfloat16, torch.float32):
        for shape in ((37, 8, M_PAD, DET, ATT), (37, 8, 5, 100, 36)):
            _, err = fused_case(gen, "bad", *shape, table, shape[2], BEAM,
                                L_GROUPS, "item", bad=FUSED_BAD_ROWS)
            worst = max(worst, err)
    out = dict(max_abs_err=worst, library_ms=None)
    for key, args, what, held in (
            ("", timed["full", ROWS, BATCH, M_PAD],
             "the beam's rows=%d M=%d" % (ROWS, M_PAD), False),
            ("beam1_", timed["beam1", BATCH, BATCH, M_REGIONS],
             "SCST's decode rows=%d (beam 1) L=%d M=%d"
             % (BATCH, SEQ_LEN, M_REGIONS), False),
            ("eval_", timed["shared", 2560, 512, M_REGIONS],
             "the eval CLI's rows=2560 (512 items x beam 5, ctrl shared) "
             "M=%d" % M_REGIONS, False),
            ("rows100_", timed["beam1", 100, 100, M_REGIONS],
             "the SCST train CLI's rows=100 (beam 1) L=%d M=%d, held "
             "stream" % (SEQ_LEN, M_REGIONS), True)):
        if held:
            ms = held_ms(lambda: kern(*args))[0]
            out[key + "empty_ms"] = held_ms(
                lambda: torch.cuda._sleep(0))[0]
        else:
            ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        bound_ms, bound_by, groups = fused_bound(args)
        log("  fused_attention at %s bf16: %.4f ms (plain %.4f ms, bound "
            "%.4f ms by %s, %d distinct groups%s)"
            % (what, ms, plain_ms, bound_ms, bound_by, groups,
               ", empty kernel %.4f ms" % out[key + "empty_ms"]
               if held else ""))
        out.update({key + "ms": ms, key + "plain_ms": plain_ms,
                    key + "bound_ms": bound_ms, key + "bound_by": bound_by,
                    key + "distinct_groups": groups})
    # f32 tables: phase 5d's beam and the eval CLI's --fused --vocab_topk
    # (the group bytes at 4 B an element in the bound)
    for key, args, what in (
            ("f32_", timed_f32["full", ROWS, BATCH, M_PAD],
             "the beam's rows=%d M=%d" % (ROWS, M_PAD)),
            ("eval_f32_", timed_f32["shared", 2560, 512, M_REGIONS],
             "the eval CLI's rows=2560 M=%d" % M_REGIONS)):
        ms = held_ms(lambda: kern(*args))[0]
        plain_ms = cuda_ms(lambda: plain(*args), iters=5)
        bound_ms, bound_by, groups = fused_bound(args)
        log("  fused_attention at %s f32 tables: %.4f ms held (plain %.4f "
            "ms, bound %.4f ms by %s, %d distinct groups)"
            % (what, ms, plain_ms, bound_ms, bound_by, groups))
        out.update({key + "ms": ms, key + "plain_ms": plain_ms,
                    key + "bound_ms": bound_ms, key + "bound_by": bound_by,
                    key + "distinct_groups": groups})
    report["fused_attention"] = out


def vocab_tie_cases(gen):
    """The tie inputs of tests/test_vocab_topk.py (duplicated columns must
    give the lowest id first), made on the card."""
    import torch
    cases = []
    for rows, r, v, k, pairs in ((16, 24, 300, 5, ((3, 10), (42, 170))),
                                 (8, 16, 700, 5, ((3, 131), (40, 296),
                                                  (512, 640))),
                                 (24, 16, 260, 4, ()),
                                 (64, 1000, 10000, 5,
                                  ((7, 9000), (1234, 1235), (9990, 9999)))):
        h2 = torch.randn((rows, r), generator=gen, device="cuda")
        w = torch.randn((r, v), generator=gen, device="cuda")
        b = torch.randn((v,), generator=gen, device="cuda")
        for a, c in pairs:
            w[:, c] = w[:, a]
            b[c] = b[a]
        # rows whose best column is duplicated: a tie at rank 0
        top = int(torch.argmax(h2[0] @ w + b))
        w[:, (top + 1) % v] = w[:, top]
        b[(top + 1) % v] = b[top]
        cases.append((h2, w, b, k))
    return cases


def vocab_near_ties(h2, w, b, got, want):
    """Rows whose ids differ; each differing id must be a near tie: the
    plain logit of the kernel's id within 1e-5 relative of the plain value
    at that rank. Returns the count of such rows."""
    import torch
    rows = torch.nonzero((got[1] != want[1]).any(1)).flatten()
    if rows.numel() == 0:
        return 0
    logits = h2[rows].float() @ w.float() + b
    for i, r in enumerate(rows.tolist()):
        kid = got[1][r].long()
        lk = logits[i, kid]
        pv = want[0][r]
        if not torch.all((lk - pv).abs() <= 1e-5 * pv.abs()):
            raise AssertionError("vocab top-k row %d: ids %s vs plain %s are "
                                 "not a near tie" % (r, got[1][r].tolist(),
                                                     want[1][r].tolist()))
    return int(rows.numel())


def hold_vocab(h2, w, b, k, exact_ids, worst, w_planes=None):
    """One input of phase 3's vocab checks: the wrapper's kernel (given an
    f32 table's `w_planes`, or making them) against its plain version,
    values and lse within rtol 1e-5 / atol 1e-6, ids exact (tie cases) or
    equal save near ties. `worst` keeps the largest absolute ("abs") and
    relative ("rel") errors seen. Returns the count of near-tie rows."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (
        vocab_topk_lse as kern, vocab_topk_lse_plain as plain)
    got = kern(h2, w, b, k, w_planes=w_planes)
    torch.cuda.synchronize()
    want = plain(h2, w, b, k)
    for g, wnt, name in ((got[0], want[0], "vals"),
                         (got[2], want[2], "lse")):
        if not torch.allclose(g, wnt, rtol=1e-5, atol=1e-6):
            raise AssertionError("vocab top-k %s beyond rtol 1e-5: %.3g"
                                 % (name, float((g - wnt).abs().max())))
        worst["abs"] = max(worst["abs"], float((g - wnt).abs().max()))
        worst["rel"] = max(worst["rel"], float(
            ((g - wnt).abs() / wnt.abs().clamp_min(1e-30)).max()))
    if exact_ids:
        if not torch.equal(got[1], want[1]):
            raise AssertionError("vocab top-k ids differ on a tie case")
        return 0
    return vocab_near_ties(h2, w, b, got, want)


def vocab_planes_bound(rows, r, v, k, h2_bytes, table_bytes):
    """(ms, by): a TMA route's function, the exact f32 product taken as
    bf16 plane products (three planes for an f32 operand, one for a bf16:
    "tma" 1 pass, "split" and "split_w" 3, "split9" 9) over the tensor
    cores' bf16 rate, or its bytes (h2, the table, f32 bias, outputs; the
    planes are the route's own) over the HBM rate."""
    passes = (3 if h2_bytes == 4 else 1) * (3 if table_bytes == 4 else 1)
    flops = passes * 2.0 * rows * r * v
    nbytes = (rows * r * h2_bytes + r * v * table_bytes + v * 4
              + rows * (2 * k + 1) * 4)
    t_ops, t_bytes = flops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def split_values(gen, rows, r):
    """f32 h2 with every kind of entry the split pass meets, made on the
    card: magnitudes 2^-126 .. 2^127 of both signs, subnormals, +-0,
    +-inf, NaNs of both signs."""
    import torch
    e = torch.rand((rows, r), generator=gen, device="cuda") * 253 - 126
    x = (torch.rand((rows, r), generator=gen, device="cuda") + 1) * torch.exp2(
        e) * torch.where(torch.rand((rows, r), generator=gen,
                                    device="cuda") < 0.5, -1.0, 1.0)
    flat = x.view(-1)
    flat[:8] = torch.tensor([0.0, -0.0, math.inf, -math.inf, 1e-40, -3e-42,
                             3.4e38, -1e-45], device="cuda")
    zero = torch.zeros((), device="cuda")
    flat[8] = zero / zero
    flat[9] = -(zero / zero)
    return x


def check_vocab_split(gen, h2, w_t):
    """The split pass (csrc vocab_split_kernel) against split_bf16x3_plain
    on the card, bit for bit: at the beam's h2, on every kind of entry at
    ragged R, and from an unaligned base (element loads); and on W_t's
    rows as `table_planes` splits them, once per table: the beam's f32
    table and every kind of entry at ragged R and V, padded."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (padded_table, split_bf16x3,
                                                 split_bf16x3_plain,
                                                 table_planes)
    cases = [("full", h2), ("special", split_values(gen, 37, 1001)),
             ("special_r1", split_values(gen, 16, 1))]
    off = torch.empty(130 * 64 + 1, device="cuda")[1:].view(130, 64)
    cases.append(("unaligned", off.copy_(split_values(gen, 130, 64))))
    for name, x in cases:
        got = split_bf16x3(x)
        torch.cuda.synchronize()
        want = split_bf16x3_plain(x)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError("split pass %s rows=%d R=%d: planes differ "
                                 "from split_bf16x3_plain" % ((name,)
                                                              + x.shape))
        log("  vocab split pass %s rows=%d R=%d: planes equal "
            "split_bf16x3_plain bit for bit" % ((name,) + tuple(x.shape)))
    for name, w in (("table", w_t), ("special_table",
                                     split_values(gen, 77, 1001)),
                    ("special_v30", split_values(gen, 1000, 30))):
        got = table_planes(padded_table(w))
        torch.cuda.synchronize()
        want = split_bf16x3_plain(w)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError("W_t's planes %s R=%d V=%d differ from "
                                 "split_bf16x3_plain" % ((name,) + w.shape))
        log("  vocab W_t planes %s R=%d V=%d (padded to %d): equal "
            "split_bf16x3_plain bit for bit" % ((name,) + tuple(w.shape)
                                                + (got.shape[2],)))


# the vocab op's routes, each with its launch count's attribute on
# vocab_topk_lse
VOCAB_ROUTES = {"sgemm": "launches_sgemm", "split": "launches_split",
                "split9": "launches_split9", "split_w": "launches_split_w",
                "tma": "launches_bf16_tma", "mma_sync": None}


def vocab_route(h2, w, k):
    """The route vocab_topk_lse takes on the card for these operands (its
    own reading of their types and layout, ops/vocab_topk.py)."""
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_launch_plan
    lhs = h2.dtype
    if lhs == torch.bfloat16 and w.dtype == torch.float32 and \
            h2.data_ptr() % 16:
        lhs = torch.float32
    aligned = w.data_ptr() % 16 == 0 and (lhs == torch.float32
                                          or h2.data_ptr() % 16 == 0)
    r, v = w.shape
    return vocab_launch_plan(h2.shape[0], h2.shape[1], v, k, lhs, w.dtype,
                             aligned, _build.sm_count(h2.device),
                             ldw=w.stride(0) if r > 1 else v + -v % 8).route


def expect_route(route, call):
    """call() (one vocab_topk_lse), asserting it was one launch, counted
    on `route` alone (bf16 launches: "tma" and "mma_sync")."""
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse as kern
    attrs = ["launches", "launches_bf16"] + [a for a in VOCAB_ROUTES.values()
                                             if a]
    before = [getattr(kern, a) for a in attrs]
    out = call()
    want = {"launches": 1, "launches_bf16": route in ("tma", "mma_sync"),
            VOCAB_ROUTES[route]: 1}
    got = {a: getattr(kern, a) - n for a, n in zip(attrs, before)}
    if any(got[a] != want.get(a, 0) for a in attrs):
        raise AssertionError("vocab top-k: launches %s, not one on the %s "
                             "route" % (got, route))
    return out


def vocab_tables(w):
    """The layouts phase 3 holds the vocab op on, of the f32 values w (R,
    V): {name: (table, w_planes)}: f32 and bf16, each contiguous and as the
    facade stores it (padded to a pitch of V rounded up to 8; the f32
    table's planes made once)."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import padded_table, table_planes
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        out[name] = (w.to(dt).contiguous(), None)
        if w.shape[1] % 8 or dt == torch.float32:
            wp = padded_table(w, dt)
            out[name + "_padded"] = (
                wp, table_planes(wp) if dt == torch.float32 else None)
    return out


def check_vocab(gen, report):
    """Phase 3 for the f32 product's routes (f32 h2 on f32 and bf16
    tables, bf16 h2 on f32 tables): on every table layout the facade makes
    (padded to a pitch of V rounded up to 8, an f32 table's planes made
    once) and contiguous: "split9" (f32 h2 and table), "split_w" (bf16 h2,
    f32 table), "split" (f32 h2, bf16 table) wherever TMA can read W_t,
    the SGEMM where it cannot (contiguous at V no multiple of 8). The tie
    cases with ids exact, ragged and full-width shapes (V 10000 and 9999)
    with ids equal save near ties, all at rtol 1e-5 / atol 1e-6, each
    check asserting its route by the launch counts; the split passes held
    bit for bit; then the times at the beam's shape of every route beside
    its bound, the SGEMM on the same values through an unaligned view, and
    the library trio."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (
        padded_table, split_bf16x3, split_bf16x3_plain, vocab_topk_lse as
        kern, vocab_topk_lse_plain as plain)
    bf16 = torch.bfloat16
    worst = {route: {"abs": 0.0, "rel": 0.0}
             for route in ("sgemm", "split", "split9", "split_w")}
    routes = {}

    def compare(h2, w, b, k, exact_ids, planes=None):
        route = vocab_route(h2, w, k)
        n = expect_route(route, lambda: hold_vocab(
            h2, w, b, k, exact_ids, worst[route], planes))
        routes[route] = routes.get(route, 0) + 1
        return n

    def each_table(h2, w, b, k, exact_ids):
        """compare() on every layout of w, f32 h2; bf16 h2 on the f32
        ones: {layout: near-tie rows}."""
        out = {}
        for name, (wt, planes) in vocab_tables(w).items():
            out[name] = compare(h2, wt, b, k, exact_ids, planes)
            if wt.dtype == torch.float32:
                out["bf16_h2_" + name] = compare(h2.to(bf16), wt, b, k,
                                                 exact_ids, planes)
        return out

    for i, (h2, w, b, k) in enumerate(vocab_tie_cases(gen)):
        each_table(h2, w, b, k, exact_ids=True)
        log("  vocab_topk tie case %d rows=%d R=%d V=%d k=%d: ids exact on "
            "every layout (routes so far: %s)"
            % (i, h2.shape[0], h2.shape[1], w.shape[1], k, routes))
    # ragged: the SGEMM's edges; ragged R (zero-padded planes), V, rows and
    # k on the split routes
    for rows, r, v, k in ((37, 77, 1001, 5), (3, 1000, 130, 1),
                          (101, 129, 257, 16), (37, 1001, 1000, 5),
                          (130, 77, 136, 16), (3, 1000, 136, 1)):
        h2 = torch.randn((rows, r), generator=gen, device="cuda")
        w = torch.randn((r, v), generator=gen, device="cuda") / r ** 0.5
        b = torch.randn((v,), generator=gen, device="cuda")
        n = each_table(h2, w, b, k, exact_ids=False)
        log("  vocab_topk ragged rows=%d R=%d V=%d k=%d: near-tie rows %s"
            % (rows, r, v, k, n))
    # full width: h2 like the LSTM's output, out_fc weights xavier-normal;
    # V 10000 and V 9999 (a ragged vocabulary, padded)
    h2 = torch.tanh(torch.randn((ROWS, RNN), generator=gen, device="cuda"))
    w = torch.randn((RNN, VOCAB), generator=gen, device="cuda") * (
        2.0 / (RNN + VOCAB)) ** 0.5
    b = 0.01 * torch.randn((VOCAB,), generator=gen, device="cuda")
    near = each_table(h2, w, b, BEAM, exact_ids=False)
    log("  vocab_topk full rows=%d R=%d V=%d k=%d: near-tie rows %s"
        % (ROWS, RNN, VOCAB, BEAM, near))
    w9999 = padded_table(w[:, :VOCAB - 1], bf16)
    b9999 = b[:VOCAB - 1].contiguous()
    near["bfloat16_v9999"] = compare(h2, w9999, b9999, BEAM, False)
    log("  vocab_topk full V=%d bf16 table padded to %d: near-tie rows %d"
        % (VOCAB - 1, w9999.stride(0), near["bfloat16_v9999"]))
    log("  vocab_topk worst error by route: %s (checks by route: %s)"
        % ({r: "%.3g absolute, %.3g relative" % (e["abs"], e["rel"])
            for r, e in worst.items()}, routes))
    for route in ("split9", "split_w", "split", "sgemm"):
        if not routes.get(route):
            raise AssertionError("phase 3 took no vocab call on the %s route"
                                 % route)
    tables = vocab_tables(w)
    check_vocab_split(gen, h2, w)

    # times at the beam's shape
    wb, _ = tables["bfloat16"]
    wf, planes = tables["float32_padded"]
    # the SGEMM on the same values: an f32 table TMA cannot read (its base
    # 4 bytes off 16)
    unaligned = torch.zeros(RNN * VOCAB + 1, device="cuda")[1:].view(
        RNN, VOCAB).copy_(w)
    h2b = h2.to(bf16)
    calls = {"split": (h2, wb, None), "split9": (h2, wf, planes),
             "split_w": (h2b, wf, planes), "sgemm": (h2, unaligned, None),
             "split_v9999": (h2, w9999, None)}
    timed = {}
    for name, (lhs, wt, pl) in calls.items():
        bb = b9999 if name == "split_v9999" else b
        expect_route(name.split("_v")[0], lambda: kern(lhs, wt, bb, BEAM,
                                                       w_planes=pl))
        timed[name] = held_ms(lambda: kern(lhs, wt, bb, BEAM,
                                           w_planes=pl))[0]
    ms = cuda_ms(lambda: kern(h2, wb, b, BEAM))
    plain_ms = cuda_ms(lambda: plain(h2, wb, b, BEAM), iters=5)
    plain_f32_ms = cuda_ms(lambda: plain(h2, wf, b, BEAM), iters=5)

    def library(table, bias=b):  # product, top-k, logsumexp (timed only)
        def call():
            logits = torch.addmm(bias, h2, table)
            return torch.topk(logits, BEAM), torch.logsumexp(logits, -1)
        return call
    library_ms = cuda_ms(library(wb.float()))
    library_f32_ms = cuda_ms(library(w))
    plain_v9999_ms = cuda_ms(lambda: plain(h2, w9999, b9999, BEAM), iters=5)
    library_v9999_ms = cuda_ms(library(w9999.float(), b9999))
    flops = 2.0 * ROWS * RNN * VOCAB
    core_bound_ms, _ = vocab_bound(ROWS, RNN, VOCAB, BEAM, 2)
    core_bound_f32_ms, _ = vocab_bound(ROWS, RNN, VOCAB, BEAM, 4)
    bounds = {"split": vocab_planes_bound(ROWS, RNN, VOCAB, BEAM, 4, 2),
              "split9": vocab_planes_bound(ROWS, RNN, VOCAB, BEAM, 4, 4),
              "split_w": vocab_planes_bound(ROWS, RNN, VOCAB, BEAM, 2, 4)}
    bound_ms, bound_by = bounds["split"]
    split = kernel_split(lambda: kern(h2, wb, b, BEAM), "vocab")
    split9 = kernel_split(lambda: kern(h2, wf, b, BEAM, w_planes=planes),
                          "vocab")
    log("  vocab_topk at rows=%d bf16 table, split route: %.4f ms (held "
        "%.4f; plain %.4f ms, library %.4f ms, bound %.4f ms by %s: three "
        "bf16 passes; the CUDA cores' f32 bound %.4f ms; %.1f f32-product "
        "TFLOP/s); V %d padded: held %.4f ms (plain %.4f ms, library %.4f "
        "ms); profiler split %s"
        % (ROWS, ms, timed["split"], plain_ms, library_ms, bound_ms, bound_by,
           core_bound_ms, flops / ms / 1e9, VOCAB - 1, timed["split_v9999"],
           plain_v9999_ms, library_v9999_ms, fmt_split(split)))
    log("  vocab_topk at rows=%d f32 table: split9 held %.4f ms (bound %.4f "
        "ms by %s: nine bf16 passes; the CUDA cores' %.4f ms), split_w (bf16 "
        "h2) held %.4f ms (bound %.4f ms), the SGEMM on the same values "
        "held %.4f ms; plain %.4f ms, library (addmm + topk + logsumexp on "
        "the f32 table) %.4f ms; split9's profiler split %s"
        % (ROWS, timed["split9"], bounds["split9"][0], bounds["split9"][1],
           core_bound_f32_ms, timed["split_w"], bounds["split_w"][0],
           timed["sgemm"], plain_f32_ms, library_f32_ms, fmt_split(split9)))
    report["vocab_topk"] = dict(
        max_abs_err=max(e["abs"] for e in worst.values()),
        max_rel_err=max(e["rel"] for e in worst.values()),
        worst_by_route=worst, checks_by_route=routes, route="split", ms=ms,
        held_ms=timed, plain_ms=plain_ms, plain_f32_ms=plain_f32_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        bounds_by_route={k: v[0] for k, v in bounds.items()},
        bound_by_route={k: v[1] for k, v in bounds.items()},
        cuda_core_bound_ms=core_bound_ms,
        cuda_core_bound_f32_ms=core_bound_f32_ms, sgemm_ms=timed["sgemm"],
        library_ms=library_ms, library_f32_ms=library_f32_ms,
        plain_v9999_ms=plain_v9999_ms, library_v9999_ms=library_v9999_ms,
        near_tie_rows=near, split_ms=split, split9_ms=split9)
    # the split pass alone (4 bytes read and 6 written an entry), a few
    # microseconds: timed on a held stream, as the Sinkhorn kernel is
    split_ms = held_ms(lambda: split_bf16x3(h2))[0]
    split_plain_ms = cuda_ms(lambda: split_bf16x3_plain(h2), iters=5)
    nbytes = ROWS * RNN * (4 + 3 * 2)
    split_bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    log("  vocab split pass at rows=%d R=%d: %.4f ms on the held stream "
        "(plain %.4f ms, bound "
        "%.4f ms by bytes, %.2f TB/s; no single library call)"
        % (ROWS, RNN, split_ms, split_plain_ms, split_bound_ms,
           nbytes / split_ms / 1e9))
    report["vocab_split"] = dict(
        max_abs_err=0.0, ms=split_ms, plain_ms=split_plain_ms,
        bound_ms=split_bound_ms, bound_by="bytes", library_ms=None)


def check_vocab_bf16(gen, report):
    """Phase 3 for the bf16-operand kernel (bf16 h2 and table): the tie
    cases with ids exact, ragged and full-width shapes with ids equal save
    near ties, all at check_vocab's rtol 1e-5 / atol 1e-6; then its times.
    The tensor cores sum the exact products in another order than the
    plain version's f32 product; the worst relative error is reported."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (
        vocab_topk_lse as kern, vocab_topk_lse_plain as plain)
    bf16 = torch.bfloat16
    worst = {"abs": 0.0, "rel": 0.0}
    routes = {}

    def compare(h2, w, b, k, exact_ids):
        route = vocab_route(h2, w, k)
        routes[route] = routes.get(route, 0) + 1
        n = expect_route(route, lambda: hold_vocab(h2, w, b, k, exact_ids,
                                                   worst))
        return n

    for i, (h2, w, b, k) in enumerate(vocab_tie_cases(gen)):
        compare(h2.to(bf16), w.to(bf16).contiguous(), b, k, exact_ids=True)
        log("  vocab_topk_bf16 tie case %d rows=%d R=%d V=%d k=%d: ids exact"
            % (i, h2.shape[0], h2.shape[1], w.shape[1], k))
    for rows, r, v, k in ((37, 77, 1001, 5), (3, 1000, 130, 1),
                          (101, 129, 257, 16)):
        h2 = torch.randn((rows, r), generator=gen, device="cuda")
        w = torch.randn((r, v), generator=gen, device="cuda") / r ** 0.5
        b = torch.randn((v,), generator=gen, device="cuda")
        n = compare(h2.to(bf16), w.to(bf16), b, k, exact_ids=False)
        log("  vocab_topk_bf16 ragged rows=%d R=%d V=%d k=%d: near-tie rows "
            "%d" % (rows, r, v, k, n))
    h2 = torch.tanh(torch.randn((ROWS, RNN), generator=gen,
                                device="cuda")).to(bf16)
    wt = (torch.randn((RNN, VOCAB), generator=gen, device="cuda") * (
        2.0 / (RNN + VOCAB)) ** 0.5).to(bf16)
    b = 0.01 * torch.randn((VOCAB,), generator=gen, device="cuda")
    near = compare(h2, wt, b, BEAM, exact_ids=False)
    route = vocab_route(h2, wt, BEAM)
    log("  vocab_topk_bf16 full rows=%d R=%d V=%d k=%d: near-tie rows %d; "
        "worst error %.3g absolute, %.3g relative; route %s (checks by "
        "route: %s)" % (ROWS, RNN, VOCAB, BEAM, near, worst["abs"],
                        worst["rel"], route, routes))
    ms = cuda_ms(lambda: kern(h2, wt, b, BEAM))
    plain_ms = cuda_ms(lambda: plain(h2, wt, b, BEAM), iters=5)
    try:
        torch.mm(h2, wt, out_dtype=torch.float32)
        kind = "torch.mm(bf16, bf16, out_dtype=float32)"

        def product():
            return torch.mm(h2, wt, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        kind = "torch.mm(bf16, bf16).float()"

        def product():
            return torch.mm(h2, wt).float()

    def library():  # cuBLAS product, bias, top-k and logsumexp (timed only)
        logits = product() + b
        return torch.topk(logits, BEAM), torch.logsumexp(logits, -1)
    library_ms = cuda_ms(library)
    product_ms = cuda_ms(product)
    k1_ms = cuda_ms(lambda: kern(h2, wt, b, 1))
    split = kernel_split(lambda: kern(h2, wt, b, BEAM), "vocab")
    split_k1 = kernel_split(lambda: kern(h2, wt, b, 1), "vocab")
    bound_ms, bound_by = vocab_planes_bound(ROWS, RNN, VOCAB, BEAM, 2, 2)
    log("  vocab_topk_bf16 at rows=%d: %.4f ms (plain %.4f ms, library "
        "%.4f ms [%s + bias, topk, logsumexp], bound %.4f ms by %s, %.1f "
        "bf16 TFLOP/s)" % (ROWS, ms, plain_ms, library_ms, kind, bound_ms,
                           bound_by, 2.0 * ROWS * RNN * VOCAB / ms / 1e9))
    log("  vocab_topk_bf16 split: k %d %s; k 1: %.4f ms, %s; the cuBLAS "
        "product alone (%s) %.4f ms"
        % (BEAM, fmt_split(split), k1_ms, fmt_split(split_k1), kind,
           product_ms))
    report["vocab_topk_bf16"] = dict(
        max_abs_err=worst["abs"], max_rel_err=worst["rel"], ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        library_kind=kind, near_tie_rows=near, k1_ms=k1_ms,
        split_ms=split, split_k1_ms=split_k1,
        library_product_ms=product_ms, route=route, checks_by_route=routes)


def vocab_nonfinite_inputs(gen, rows, r, v, case):
    """Phase 3's non-finite vocab inputs, made on the card: "rows" puts a
    0/0 descriptor (NaN) in row 3, +-inf products in row 5 (one +inf
    entry, the weights' signs) and an all -inf row 7 among finite rows;
    "columns" a NaN weight in column 9 (NaN in every row) and a +inf bias
    in the last column."""
    import torch
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device="cuda"))
    w = torch.randn((r, v), generator=gen, device="cuda") / r ** 0.5
    b = 0.01 * torch.randn((v,), generator=gen, device="cuda")
    zero = torch.zeros((r,), device="cuda")
    if case == "rows":
        h2[3] = zero / zero
        h2[5] = 0.0
        h2[5, 2] = math.inf
        h2[7] = 0.0
        h2[7, 4] = -math.inf
        w[4] = w[4].abs() + 0.5
    else:
        w[6, 9] = zero[0] / zero[0]
        b[v - 1] = math.inf
    return h2, w, b


def check_vocab_nonfinite(gen, report):
    """The vocab kernels on non-finite logits (ROADMAP §3): every route
    against its plain version, which ranks as jax.lax.top_k and sums as
    jax.nn.logsumexp: "split9" (f32 h2 and table), "split_w" (bf16 h2, f32
    table), "split" (f32 h2, bf16 table), "tma" (bf16) at V 10000 and, padded,
    at V 1001; the SGEMM and mma.sync on the contiguous V 1001. An f32
    table's routes are held to `vocab_planes_plain` (their function: an
    infinite h2 entry meets W_t's zero planes, 0 x inf = NaN where the f32
    product gives +-inf; ROADMAP §3). Values and lse at phase 3's bar, NaN
    and +-inf exactly where the plain version has them; ids exact on the
    rows with a non-finite logit, equal save near ties on the finite rows
    around them; no id outside [0, V)."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (
        padded_table, vocab_planes_plain, vocab_topk_lse as kern,
        vocab_topk_lse_plain)
    bf16 = torch.bfloat16
    out = {}
    for rows, r, v, pad in ((300, RNN, VOCAB, False), (37, 77, 1001, False),
                            (37, 80, 1001, True)):
        for case in ("rows", "columns"):
            h2, w, b = vocab_nonfinite_inputs(gen, rows, r, v, case)
            layout = padded_table if pad else (lambda x, dt: x.to(dt))
            for name, lhs, table in (
                    ("f32", h2, layout(w, torch.float32)),
                    ("f32_bf16table", h2, layout(w, bf16)),
                    ("bf16", h2.to(bf16), layout(w, bf16)),
                    ("bf16_f32table", h2.to(bf16),
                     layout(w, torch.float32))):
                route = vocab_route(lhs, table, BEAM)
                got = expect_route(route, lambda: kern(lhs, table, b, BEAM))
                name += "_" + route
                torch.cuda.synchronize()
                plain = (vocab_planes_plain if route in ("split9", "split_w")
                         else vocab_topk_lse_plain)
                want = plain(lhs, table, b, BEAM)
                ids = got[1]
                if int(ids.min()) < 0 or int(ids.max()) >= v:
                    raise AssertionError(
                        "vocab top-k %s %s R=%d V=%d: ids outside [0, V)"
                        % (name, case, r, v))
                bad = ~torch.isfinite(
                    lhs.float() @ table.float() + b).all(1)
                for g, wnt, what in ((got[0], want[0], "vals"),
                                     (got[2], want[2], "lse")):
                    # NaN and +-inf where the plain version has them, the
                    # finite values at phase 3's bar
                    torch.testing.assert_close(
                        g, wnt, rtol=1e-5, atol=1e-6, equal_nan=True,
                        msg=lambda m: "vocab top-k %s %s %s: %s"
                        % (name, case, what, m))
                if not torch.equal(ids[bad], want[1][bad]):
                    raise AssertionError(
                        "vocab top-k %s %s R=%d V=%d: ids differ on a "
                        "non-finite row" % (name, case, r, v))
                fin = torch.nonzero(~bad).flatten()
                near = vocab_near_ties(
                    lhs[fin], table, b, (got[0][fin], ids[fin]),
                    (want[0][fin], want[1][fin]))
                key = "%s_%s_r%d_v%d%s" % (name, case, r, v,
                                           "_padded" if pad else "")
                out[key] = dict(nonfinite_rows=int(bad.sum()),
                                near_tie_rows=near)
                log("  vocab_topk non-finite %-22s %-7s rows=%d R=%d V=%d%s: "
                    "%d non-finite rows exact, %d finite rows (near ties "
                    "%d)" % (name, case, rows, r, v, " padded" if pad else "",
                             int(bad.sum()), int(fin.numel()), near))
    report["vocab_nonfinite"] = out
    report["vocab_nonfinite_facade"] = check_facade_nonfinite(gen)


def check_facade_nonfinite(gen, unit=3, word=20):
    """The captioner facade's vocab head on an out_fc table with a -inf
    weight (W_t[unit, word]), bf16 and f32 tables, at the beam's shape: the
    facade reads once that the table is non-finite and sends the f32 h2 to
    the SGEMM, one launch on "sgemm" and no split pass, where a finite
    table takes "split" or "split9". h2 is exact in bf16, its `unit` column
    > 0, 0 and < 0 by row (the word's logit -inf, NaN, +inf), so the split
    routes' zero planes would give NaN on every row (`vocab_planes_plain`);
    the SGEMM gives the plain version's values and logsumexp (+-inf and
    NaN where it has them), ids exact on the rows whose top k holds a
    non-finite value and equal save near ties on the others. Then its held
    time beside the plain version, the library trio and the CUDA cores'
    f32 bound. Returns {table: readings}."""
    import torch
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.ops.vocab_topk import (
        split_bf16x3, vocab_planes_plain, vocab_topk_lse_plain as plain)
    params = init_captioner_params(torch.Generator().manual_seed(0),
                                   CaptionerConfig(**MAIN_CFG))
    params["out_fc"]["weight"][word, unit] = -math.inf
    h2 = torch.tanh(torch.randn((ROWS, RNN), generator=gen, device="cuda"))
    h2[:, unit] = h2[:, unit].abs() + 0.5
    h2[1::5, unit] = 0.0
    h2[2::5, unit] = -h2[2::5, unit]
    h2 = h2.bfloat16().float()
    top_bad = torch.zeros(ROWS, dtype=torch.bool, device="cuda")
    top_bad[1::5] = top_bad[2::5] = True
    out = {}
    for bf16 in (True, False):
        name = "bfloat16" if bf16 else "float32"
        cap = main_captioner(params=params, bf16=bf16)
        fn, (w_t, b) = cap._vocab_fn_and_tables(BEAM)
        if cap._finite_table is not False:
            raise AssertionError("facade: a -inf weight in the %s table not "
                                 "read as non-finite" % name)
        finite_route = vocab_route(h2, w_t, BEAM)
        passes = split_bf16x3.launches
        got = expect_route("sgemm", lambda: fn(h2, w_t, b))
        torch.cuda.synchronize()
        if split_bf16x3.launches != passes:
            raise AssertionError("facade, non-finite %s table: a split pass"
                                 % name)
        want = plain(h2, w_t, b, BEAM)
        lse = want[2].flatten()
        if not (torch.isnan(lse[1::5]).all() and torch.isposinf(
                lse[2::5]).all() and torch.isfinite(lse[0::5]).all()):
            raise AssertionError("facade: the inputs miss their +inf, NaN "
                                 "and -inf rows")
        planes_nan = int(torch.isnan(vocab_planes_plain(
            h2, w_t, b, BEAM)[2]).sum())
        for g, wnt, what in ((got[0], want[0], "vals"),
                             (got[2], want[2], "lse")):
            torch.testing.assert_close(
                g, wnt, rtol=1e-5, atol=1e-6, equal_nan=True,
                msg=lambda m: "facade non-finite %s table %s: %s"
                % (name, what, m))
        if not torch.equal(got[1][top_bad], want[1][top_bad]):
            raise AssertionError("facade non-finite %s table: ids differ on "
                                 "a row whose top k is non-finite" % name)
        keep = torch.nonzero(~top_bad).flatten()
        near = vocab_near_ties(h2[keep], w_t, b, (got[0][keep],
                                                   got[1][keep]),
                               (want[0][keep], want[1][keep]))
        ms = held_ms(lambda: fn(h2, w_t, b))[0]
        plain_ms = cuda_ms(lambda: plain(h2, w_t, b, BEAM), iters=5)
        wf = w_t.float()

        def library():  # product, top-k, logsumexp (timed only)
            logits = torch.addmm(b, h2, wf)
            return torch.topk(logits, BEAM), torch.logsumexp(logits, -1)
        library_ms = cuda_ms(library)
        bound_ms, bound_by = vocab_bound(ROWS, RNN, VOCAB, BEAM,
                                         2 if bf16 else 4)
        log("  vocab_topk facade, non-finite %s table (W_t[%d, %d] = -inf) "
            "rows=%d R=%d V=%d: route sgemm (a finite table: %s), no split "
            "pass; %d +inf and %d NaN rows exact (the planes would give %d "
            "NaN rows), near ties %d on the rest; held %.4f ms (plain %.4f "
            "ms, library %.4f ms, the CUDA cores' bound %.4f ms by %s)"
            % (name, unit, word, ROWS, RNN, VOCAB, finite_route,
               int(torch.isposinf(lse).sum()), int(torch.isnan(lse).sum()),
               planes_nan, near, ms, plain_ms, library_ms, bound_ms,
               bound_by))
        out[name] = dict(route="sgemm", finite_route=finite_route,
                         planes_nan_rows=planes_nan, near_tie_rows=near,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        del cap, fn, w_t, b, got, want
    return out


def sinkhorn_bound(s, n, iters):
    """Least time for one call: each matrix read once and written once in
    f32 over the HBM rate, or its f32 operations over the f32 rate (per
    element: the division by tau and exp, then per iteration two sums' adds
    and two divisions)."""
    nbytes = 2 * s * n * n * 4
    ops = s * n * n * (2 + 4 * iters)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_sinkhorn(gen, report):
    import torch
    from vsrcic_tpu_torch.ops.sinkhorn import (
        sinkhorn_normalize as kern, sinkhorn_normalize_in_order as in_order,
        sinkhorn_normalize_plain as plain)
    worst = 0.0
    timed = None
    inexact = []
    for n in SINK_CASE_N:
        errs = []
        for s in SINK_CASE_S:
            # scores as sinkhorn_net_apply hands them over: tanh, in (-1, 1)
            x = torch.tanh(torch.randn((s, n, n), generator=gen,
                                       device="cuda"))
            got = kern(x, SINK_ITERS, SINK_TAU)
            torch.cuda.synchronize()
            want = plain(x, SINK_ITERS, SINK_TAU)
            err = float((got - want).abs().max())
            if not err <= 1e-6:
                raise AssertionError("sinkhorn kernel disagrees with its "
                                     "plain version beyond 1e-6 (%.3g) at "
                                     "S=%d n=%d" % (err, s, n))
            errs.append(err)
            ordered = in_order(x, SINK_ITERS, SINK_TAU)
            if not torch.equal(got, ordered):  # the same IEEE steps
                inexact.append((s, n, float((got - ordered).abs().max())))
            if (s, n) == (SINK_S, SINK_N):
                timed = x
        log("  sinkhorn n=%d at S in %s: max_abs_err=%s"
            % (n, SINK_CASE_S, " ".join("%.3g" % e for e in errs)))
        worst = max(worst, *errs)
    if inexact:
        raise AssertionError("sinkhorn kernel differs from its arithmetic "
                             "replayed in PyTorch at (S, n, max diff) %s"
                             % inexact)
    log("  sinkhorn: bit-identical to its arithmetic replayed in PyTorch at "
        "all %d (S, n)" % (len(SINK_CASE_N) * len(SINK_CASE_S)))

    def call():
        return kern(timed, SINK_ITERS, SINK_TAU)
    if not torch.equal(call(), call()):
        raise AssertionError("two sinkhorn launches on one input differ")
    ms, host_ms = held_ms(call)
    fixed_ms, _ = held_ms(lambda: kern(timed, 0, SINK_TAU))
    prof_ms, prof_kernels = profiled_ms(call, "sinkhorn")
    plain_ms = cuda_ms(lambda: plain(timed, SINK_ITERS, SINK_TAU), iters=20)
    bound_ms, bound_by = sinkhorn_bound(SINK_S, SINK_N, SINK_ITERS)
    log("  sinkhorn at S=%d n=%d, %d iterations: %.4f ms on the held stream "
        "(%.4f ms at 0 iterations; profiler %s ms per call over %d kernels; "
        "the wrapper's host time %.4f ms per call), plain %.4f ms, bound "
        "%.6f ms by %s; no single library call; two launches bit-identical"
        % (SINK_S, SINK_N, SINK_ITERS, ms, fixed_ms,
           "not measured" if prof_ms is None else "%.4f" % prof_ms,
           prof_kernels, host_ms, plain_ms, bound_ms, bound_by))
    report["sinkhorn"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, profiler_ms=prof_ms,
                              profiler_kernels=prof_kernels,
                              host_ms_per_call=host_ms,
                              ms_at_0_iters=fixed_ms)


# ---------------------------------------------------------------------------
# phase 3m: the memory check
# ---------------------------------------------------------------------------

# the CUDA kernels behind each row of the kernels line (its memcheck counts)
ROW_KERNELS = {
    "fused_attention": ("fused_attention",),
    "vocab_topk": ("vocab_tma", "vocab_tile", "vocab_merge"),
    "sinkhorn": ("sinkhorn_packed", "sinkhorn_block"),
    "vocab_topk_bf16": ("vocab_tma", "vocab_tile_bf16", "vocab_merge"),
    "vocab_split": ("vocab_split",),
    "vocab_topk_split9": ("vocab_tma", "vocab_merge"),
    "vocab_topk_split_w": ("vocab_tma", "vocab_merge"),
}
# each row's call in time_checked
ROW_CALL = {"fused_attention": "fused_attention", "vocab_topk": "split",
            "sinkhorn": "sinkhorn_packed", "vocab_topk_bf16": "tma",
            "vocab_split": "split_pass", "vocab_topk_split9": "split9",
            "vocab_topk_split_w": "split_w"}


def time_checked(gen, lib):
    """Each kernel's launch function at its main path's shape on the
    default library and on the checked one `lib`, in turns on one held
    stream: {call: {"ms", "checked_ms"}}. The fused kernel at the beam's
    rows (bf16 tables, M 24); every vocab route at the beam's shape, h2's
    planes made beforehand ("split", "split9"), the split pass alone;
    the Sinkhorn kernel at the pipeline's S 1536, n 10 (packed) and at n
    33 (one block a matrix)."""
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops import fused_attention as fa
    from vsrcic_tpu_torch.ops import sinkhorn as sk
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    dflt = _build.library()
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    bf16 = torch.bfloat16
    calls = {}
    args = fused_inputs(gen, ROWS, BATCH, M_PAD, DET, ATT, bf16, M_REGIONS)
    plan = fa.fused_launch_plan(ROWS, M_PAD, DET, ATT, 2, True, sms)
    out = (torch.empty((ROWS, DET), device=dev),
           torch.empty((ROWS, 1), device=dev))
    calls["fused_attention"] = (
        lambda L, plan=plan: fa._launch(L, plan, *args, *out))
    h2 = torch.tanh(torch.randn((ROWS, RNN), generator=gen, device=dev))
    w = torch.randn((RNN, VOCAB), generator=gen, device=dev) * (
        2.0 / (RNN + VOCAB)) ** 0.5
    b = 0.01 * torch.randn((VOCAB,), generator=gen, device=dev)
    wb, wf = vt.padded_table(w, bf16), vt.padded_table(w)
    wp = vt.table_planes(wf)
    h2_planes = vt.split_bf16x3(h2)
    for route, lhs, wt, planes, aligned, finite in (
            ("split", h2, wb, None, True, True),
            ("split9", h2, wf, wp, True, True),
            ("split_w", h2.to(bf16), wf, wp, True, True),
            ("tma", h2.to(bf16), wb, None, True, True),
            ("mma_sync", h2.to(bf16), wb, None, False, True),
            ("sgemm", h2, wb, None, True, False)):
        plan = vt.vocab_launch_plan(ROWS, RNN, VOCAB, BEAM, lhs.dtype,
                                    wt.dtype, aligned, sms,
                                    ldw=wt.stride(0), finite_table=finite)
        if plan.route in vt.PLANES and plan.cluster > 1:
            plan = vt.vocab_launch_plan(
                ROWS, RNN, VOCAB, BEAM, lhs.dtype, wt.dtype, aligned, sms,
                vt.resident_clusters(dev, plan.stages, plan.planes,
                                     plan.w_planes), wt.stride(0), finite)
        if plan.route != route:
            raise AssertionError("time_checked: %s took %s"
                                 % (route, plan.route))
        outs, parts = vt.vocab_buffers(plan, ROWS, VOCAB, BEAM, dev)
        calls[route] = (lambda L, plan=plan, lhs=lhs, wt=wt, planes=planes,
                        outs=outs, parts=parts: vt._launch(
                            L, plan, lhs, wt, b, BEAM, planes,
                            h2_planes if plan.planes > 1 else None, parts,
                            outs))
    split_out = torch.empty_like(h2_planes)
    calls["split_pass"] = lambda L: vt._split_launch(L, h2, split_out)
    for name, n in (("sinkhorn_packed", SINK_N), ("sinkhorn_block", 33)):
        x = torch.tanh(torch.randn((SINK_S, n, n), generator=gen,
                                   device=dev))
        calls[name] = (lambda L, x=x, o=torch.empty_like(x): sk._launch(
            L, x, SINK_ITERS, SINK_TAU, o))
    out_ms = {}
    for name, call in calls.items():
        ms = held_ms(lambda: call(dflt), iters=20)[0]
        checked_ms = held_ms(lambda: call(lib), iters=20)[0]
        out_ms[name] = {"ms": ms, "checked_ms": checked_ms}
        log("  memcheck: %-16s default %.4f ms, checked %.4f ms (x%.2f), "
            "held stream" % (name, ms, checked_ms, checked_ms / ms))
    return out_ms


def check_memcheck(gen, report, pending=None):
    """Phase 3m (tools/memcheck.py): the checked build over the sweep of
    every launch plan on guarded buffers, one line per CUDA kernel; then
    time_checked. `pending`: the thread building the checked library since
    phase 2, joined first. Raises on any fault, guard breach, changed
    input or failed case, or a kernel no case launched."""
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.tools import memcheck
    t0 = time.perf_counter()
    if pending is not None:
        pending.join()
    build_s = _build.last_checked_build_seconds  # the thread's build
    lib = _build.library(checked=True)
    build_s = build_s or _build.last_checked_build_seconds
    wait_s = time.perf_counter() - t0
    log("  memcheck: checked build (-DVSRCIC_CHECKED=1 -lineinfo) in %.1f s "
        "of nvcc beside phase 2's, ready %.1f s into phase 3m"
        % (build_s, wait_s))
    for line in _build.last_checked_build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("    checked: " + line.strip())
    t0 = time.perf_counter()
    results, counts, failures = memcheck.sweep(lib, log=log)
    sweep_s = time.perf_counter() - t0
    for k, c in counts.items():
        log("  memcheck %-16s cases %4d, launches %6d, faults %d, guard "
            "breaches %d, changed inputs %d"
            % (k, c["cases"], c["launches"], c["faults"], c["breaches"],
               c["changed"]))
    rows = {row: {"cases": sum(1 for r in results
                               if any(k in r["launches"] for k in ks)),
                  "launches": sum(counts[k]["launches"] for k in ks),
                  "faults": sum(counts[k]["faults"] for k in ks),
                  "kernels": list(ks)}
            for row, ks in ROW_KERNELS.items()}
    bad = {k: c for k, c in counts.items()
           if c["faults"] or c["breaches"] or c["changed"] or not c["cases"]}
    log("  memcheck: %d cases in %.1f s, %d failed"
        % (len(results), sweep_s, len(failures)))
    if failures or bad:
        raise AssertionError("memcheck: %d cases failed (%s); kernels with "
                             "faults, breaches, changed inputs or no case: "
                             "%s" % (len(failures), failures[:5], bad))
    checked = time_checked(gen, lib)
    report["memcheck"] = dict(
        checked_build_seconds=build_s,
        wait_seconds=wait_s, sweep_seconds=sweep_s, cases=len(results),
        by_kernel=counts, by_row=rows, checked_ms=checked)


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def replay_golden(report):
    import numpy as np
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.utils.params import unflatten
    path = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                        "golden_beam.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    params = unflatten({k[len("param/"):]: v for k, v in g.items()
                        if k.startswith("param/")})
    cfg = CaptionerConfig(**json.loads(str(g["config"])))
    table = json.loads(str(g["verb_table"]))
    out = {}
    for name, kw in (("strict", {}),
                     ("fast_bf16", dict(use_fused_attention=True,
                                        use_vocab_topk=True,
                                        table_dtype=torch.bfloat16))):
        cap = ControllableCaptioner(cfg, params=params, verb_2_vob_all=table,
                                    device="cuda", **kw)
        res = cap.beam_search_v(g["detections"], g["det_groups"],
                                g["verb_list"], eos_word=int(g["eos_word"]),
                                beam_size=int(g["beam_size"]))
        for f in ("words", "gates"):
            got = getattr(res, f).cpu().numpy()
            if not np.array_equal(got, g[name + "/" + f]):
                raise AssertionError("golden replay %s: %s differ from JAX"
                                     % (name, f))
        err = max(float(np.abs(getattr(res, f).cpu().numpy()
                               - g[name + "/" + f]).max())
                  for f in ("scores", "word_logps", "gate_logps"))
        log("  golden %s: words and gates identical to JAX; max logprob "
            "diff %.3g" % (name, err))
        out[name] = err
    report["golden_max_logprob_diff"] = out


def replay_golden_bf16(report):
    """Phase 4 for vsrcic_tpu_torch/testdata/golden_beam_bf16.npz (written
    by `python tests/torch_parity.py --bf16`): each path through the
    kernels gives JAX's words and gates; the bf16 kernel launches under
    the variable on bf16 tables."""
    import numpy as np
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse
    from vsrcic_tpu_torch.tools import golden_bf16 as gb
    g = gb.load()
    out = {}
    for path in gb.PATHS:
        before = vocab_topk_lse.launches_bf16
        res = gb.replay(g, path, "cuda")
        n_bf16 = vocab_topk_lse.launches_bf16 - before
        if (n_bf16 > 0) != (path == "lhs_bf16"):
            raise AssertionError("golden bf16 replay %s: %d bf16 vocab "
                                 "launches" % (path, n_bf16))
        for f in ("words", "gates"):
            if not np.array_equal(getattr(res, f).cpu().numpy(),
                                  g[path + "/" + f]):
                raise AssertionError("golden bf16 replay %s: %s differ from "
                                     "JAX" % (path, f))
        err = max(float(np.abs(getattr(res, f).cpu().numpy()
                               - g[path + "/" + f]).max())
                  for f in ("scores", "word_logps", "gate_logps"))
        log("  golden bf16 %s: words and gates identical to JAX; max "
            "logprob diff %.3g; bf16 vocab launches %d" % (path, err, n_bf16))
        out[path] = err
    report["golden_bf16_max_logprob_diff"] = out


def main_inputs():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    detections = torch.randn((BATCH, N_DET, DET), generator=gen,
                             device="cuda")
    det_groups = torch.randn((BATCH, L_GROUPS, M_REGIONS, DET),
                             generator=gen, device="cuda")
    det_groups = torch.nn.functional.pad(det_groups.to(torch.bfloat16),
                                         (0, 0, 0, M_PAD - M_REGIONS))
    is_verb = torch.rand((BATCH, L_GROUPS), generator=gen,
                         device="cuda") < 0.15
    verbs = torch.randint(1, 150, (BATCH, L_GROUPS), generator=gen,
                          device="cuda")
    verb_list = torch.where(is_verb, verbs, torch.full_like(verbs, -1))
    return detections, det_groups.contiguous(), verb_list


def check_result(res):
    import torch
    assert res.words.shape == (BATCH, BEAM, SEQ_LEN), res.words.shape
    assert res.gates.shape == (BATCH, BEAM, SEQ_LEN)
    assert bool(((res.words >= 0) & (res.words < VOCAB)).all())
    assert bool(((res.gates >= 0) & (res.gates <= 1)).all())
    assert bool(torch.isfinite(res.scores).all())
    assert bool((res.scores[:, :-1] >= res.scores[:, 1:]).all()), \
        "beams not sorted by score"


MAIN_CFG = dict(seq_len=SEQ_LEN, vocab_size=VOCAB, bos_idx=2,
                det_feat_size=DET, input_encoding_size=EMB, rnn_size=RNN,
                att_size=ATT)
VERBS = {str(i): [5 + i, 40 + i] for i in range(1, 200)}


def main_captioner(mode=True, params=None, decode_dtype=None, bf16=True):
    """The bench.py configuration, weights from seed 0 unless `params`;
    mode True runs the kernels, "plain" their plain versions (same
    tables), False neither (the strict beam); bf16 tables, or f32 ones
    (table_dtype None) unless `bf16`."""
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    return ControllableCaptioner(
        CaptionerConfig(**MAIN_CFG), params=params, seed=0,
        verb_2_vob_all=VERBS, use_fused_attention=mode, use_vocab_topk=mode,
        table_dtype=torch.bfloat16 if bf16 else None, device="cuda",
        decode_dtype=decode_dtype)


def run_main_path(report):
    import torch
    t0 = time.perf_counter()
    fast = main_captioner()
    detections, det_groups, verb_list = main_inputs()
    torch.cuda.synchronize()
    log("  set-up (weights from seed 0, inputs): %.1f s"
        % (time.perf_counter() - t0))

    def run(cap):
        return cap.beam_search_v(detections, det_groups, verb_list,
                                 eos_word=3, beam_size=BEAM)

    n_batches = 3
    inputs = (detections, det_groups, verb_list)
    outs, dt, launches = timed_batches(fast, inputs, n_batches)
    caps = BATCH * n_batches / dt
    log("  main path: %d batches of %d captions (beam %d) in %.3f s: %.1f "
        "captions/s; launches %s" % (n_batches, BATCH, BEAM, dt, caps,
                                     launches))
    # every vocab launch on the split route (f32 h2, bf16 table), after
    # its split pass
    want = expected_launches(SEQ_LEN * n_batches, "split", splits=1)
    if launches != want:
        raise AssertionError("launches %s in %d batches, expected %s"
                             % (launches, n_batches, want))
    for res in outs[1:]:
        if not (torch.equal(res.words, outs[0].words)
                and torch.equal(res.gates, outs[0].gates)):
            raise AssertionError("repeated batches decode differently")
    report["main_path"] = dict(captions_per_s=caps, seconds=dt,
                               batches=n_batches, launches=launches,
                               peak_mem_gb=torch.cuda.max_memory_allocated()
                               / 1e9)
    # the checked run: every vocab call held to its plain version, the plain
    # result going on (the fused kernel's own: phases 3 and 6 hold it), so
    # that the runs differ by the split route's sums alone; each caption
    # that differs needs a vocab near-tie row
    check = PlainCheck(plain_on=("vocab_topk",))
    with call_sites(check):
        checked = run(fast)
    torch.cuda.synchronize()
    differ = int(round((1 - caption_share(outs[0], checked)) * BATCH))
    log("  checked run: calls %s, max_abs_err %s, vocab near-tie rows %d; "
        "captions differing from it %d"
        % (check.calls, {k: "%.3g" % v for k, v in check.err.items()},
           check.near_tie_rows, differ))
    if differ > check.near_tie_rows:
        raise AssertionError("phase 5: %d captions differ between the vocab "
                             "kernel and its plain version, with %d near-tie "
                             "rows to explain them"
                             % (differ, check.near_tie_rows))
    report["main_path"].update(
        checked_calls=check.calls, checked_max_abs_err=check.err,
        near_tie_rows=check.near_tie_rows, differ_from_checked=differ)

    # phase 6: the same batch through the plain versions on the card
    plain = main_captioner("plain", params=fast.params)
    t0 = time.perf_counter()
    ref = run(plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_result(ref)
    same = ((outs[0].words == ref.words).all(-1)
            & (outs[0].gates == ref.gates).all(-1))
    share = float(same.float().mean())
    log("  plain versions: %.3f s per batch; captions with identical words "
        "and gates: %.4f" % (plain_s, share))
    if share < 0.99:
        raise AssertionError("only %.4f of captions match the plain path"
                             % share)
    report["main_path"].update(plain_seconds_per_batch=plain_s,
                               identical_share=share)
    return launches, fast, inputs, outs[0]


def run_f32_tables(report, fast, inputs):
    """Phase 5d: phase 5's beam on f32 tables (table_dtype None, as the
    eval CLI's --fused --vocab_topk without --bf16_tables): three timed
    batches, every vocab launch on the nine-plane route ("split9", after
    h2's split pass; W_t's planes made once, with the tables); its captions
    equal a checked run's (the vocab op's plain result going on) save
    vocab near ties, and >= 0.99 of them the plain path's (phase 6's bar);
    then one batch under VSRCIC_VOCAB_LHS_BF16=1 on the same tables, every
    vocab launch on "split_w" (bf16 h2, W_t's planes). Returns the launch
    counts of both."""
    import torch
    from vsrcic_tpu_torch.tools.golden_bf16 import lhs_bf16
    cap = main_captioner(params=fast.params, bf16=False)
    n_batches = 3
    outs, dt, launches = timed_batches(cap, inputs, n_batches)
    caps = BATCH * n_batches / dt
    base = report["main_path"]["captions_per_s"]
    log("  5d f32 tables: %d batches in %.3f s: %.1f captions/s (phase 5, "
        "bf16 tables: %.1f); launches %s" % (n_batches, dt, caps, base,
                                             launches))
    want = expected_launches(SEQ_LEN * n_batches, "split9", splits=1)
    if launches != want:
        raise AssertionError("5d launches %s, expected %s" % (launches,
                                                              want))
    check = PlainCheck(plain_on=("vocab_topk",))
    detections, det_groups, verb_list = inputs

    def run(c):
        return c.beam_search_v(detections, det_groups, verb_list,
                               eos_word=3, beam_size=BEAM)
    with call_sites(check):
        checked = run(cap)
    torch.cuda.synchronize()
    differ = int(round((1 - caption_share(outs[0], checked)) * BATCH))
    ref = run(main_captioner("plain", params=fast.params, bf16=False))
    torch.cuda.synchronize()
    check_result(ref)
    same = ((outs[0].words == ref.words).all(-1)
            & (outs[0].gates == ref.gates).all(-1))
    share = float(same.float().mean())
    log("  5d checked run: calls %s, max_abs_err %s, vocab near-tie rows %d; "
        "captions differing from it %d; identical to the plain path's %.4f"
        % (check.calls, {k: "%.3g" % v for k, v in check.err.items()},
           check.near_tie_rows, differ, share))
    if differ > check.near_tie_rows:
        raise AssertionError("5d: %d captions differ between the vocab "
                             "kernel and its plain version, with %d near-tie "
                             "rows to explain them"
                             % (differ, check.near_tie_rows))
    if share < 0.99:
        raise AssertionError("5d: only %.4f of captions match the plain path"
                             % share)
    with lhs_bf16(True):
        _, dt_w, launches_w = timed_batches(cap, inputs, 1)
    log("  5d under VSRCIC_VOCAB_LHS_BF16=1: 1 batch in %.3f s: %.1f "
        "captions/s; launches %s" % (dt_w, BATCH / dt_w, launches_w))
    if launches_w != expected_launches(SEQ_LEN, "split_w"):
        raise AssertionError("5d lhs bf16 launches %s" % launches_w)
    report["f32_tables"] = dict(
        captions_per_s=caps, seconds=dt, batches=n_batches,
        launches=launches, checked_calls=check.calls,
        checked_max_abs_err=check.err, near_tie_rows=check.near_tie_rows,
        differ_from_checked=differ, identical_share=share,
        lhs_bf16=dict(captions_per_s=BATCH / dt_w, seconds=dt_w,
                      launches=launches_w))
    return launches, launches_w


def caption_share(res, ref):
    """The share of items whose caption, the best beam's words and gates
    (what the eval CLI dumps), equals ref's."""
    same = ((res.words[:, 0] == ref.words[:, 0]).all(-1)
            & (res.gates[:, 0] == ref.gates[:, 0]).all(-1))
    return float(same.float().mean())


def beam_counters():
    """{name: (wrapper, attribute)}: the beam's launch counts, the vocab
    op's by route."""
    from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention
    from vsrcic_tpu_torch.ops.vocab_topk import split_bf16x3, vocab_topk_lse
    out = {"fused_attention": (fused_group_attention, "launches")}
    for name, attr in (("vocab_topk", "launches"),
                       ("vocab_topk_bf16", "launches_bf16"),
                       ("vocab_topk_bf16_tma", "launches_bf16_tma"),
                       ("vocab_topk_split", "launches_split"),
                       ("vocab_topk_split9", "launches_split9"),
                       ("vocab_topk_split_w", "launches_split_w"),
                       ("vocab_topk_sgemm", "launches_sgemm")):
        out[name] = (vocab_topk_lse, attr)
    out["vocab_split"] = (split_bf16x3, "launches")
    return out


def expected_launches(n, route=None, splits=0):
    """The launch counts of `n` beam steps with the kernels: one fused and
    one vocab launch a step, on `route` (a vocab route of
    ops/vocab_topk.py), with `splits` split passes a step; with route None
    no kernel."""
    bf16 = route in ("tma", "mma_sync")
    want = {name: 0 for name in beam_counters()}
    if route is not None:
        want.update({"fused_attention": n, "vocab_topk": n,
                     "vocab_topk_bf16": n if bf16 else 0,
                     "vocab_split": n * splits})
        key = {"tma": "vocab_topk_bf16_tma"}.get(route,
                                                 "vocab_topk_" + route)
        if key in want:
            want[key] = n
    return want


def timed_batches(cap, inputs, n_batches=3):
    """One warm-up batch of `inputs` (main_inputs()), then n_batches timed
    with the launch counts reset just before and read just after, every
    result checked: (outputs, seconds, launches)."""
    import torch
    detections, det_groups, verb_list = inputs

    def run():
        return cap.beam_search_v(detections, det_groups, verb_list,
                                 eos_word=3, beam_size=BEAM)
    run()
    torch.cuda.synchronize()
    counters = beam_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    outs = [run() for _ in range(n_batches)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: getattr(obj, attr)
                for name, (obj, attr) in counters.items()}
    for res in outs:
        check_result(res)
    return outs, dt, launches


def run_bf16_paths(report, fast, inputs, ref):
    """Phases 5b (VSRCIC_VOCAB_LHS_BF16=1) and 5c (decode_dtype=bfloat16,
    strict and fast) on phase 5's captioner `fast` and `inputs`; `ref` is
    phase 5's first batch. Returns 5b's launch counts."""
    import torch
    from vsrcic_tpu_torch.tools.golden_bf16 import lhs_bf16
    base = report["main_path"]["captions_per_s"]
    n_batches = 3
    with lhs_bf16(True):
        outs, dt, launches = timed_batches(fast, inputs, n_batches)
        caps = BATCH * n_batches / dt
        log("  5b lhs bf16: %d batches in %.3f s: %.1f captions/s (phase 5: "
            "%.1f); launches %s" % (n_batches, dt, caps, base, launches))
        # every vocab launch a bf16 one, on the TMA route
        want = expected_launches(SEQ_LEN * n_batches, "tma")
        if launches != want:
            raise AssertionError("5b launches %s, expected %s" % (launches,
                                                                  want))
        # only the vocab op's plain result goes on (the fused kernel's own
        # does: phases 3 and 6 hold it), so that the runs differ by the
        # vocab op alone
        check = PlainCheck(plain_on=("vocab_topk",))
        detections, det_groups, verb_list = inputs
        with call_sites(check):
            checked = fast.beam_search_v(detections, det_groups, verb_list,
                                         eos_word=3, beam_size=BEAM)
        torch.cuda.synchronize()
    differ = int(round((1 - caption_share(outs[0], checked)) * BATCH))
    kept = caption_share(outs[0], ref)
    log("  5b checked run: calls %s, max_abs_err %s, vocab near-tie rows %d; "
        "captions differing from it %d; phase 5's captions kept %.4f"
        % (check.calls, {k: "%.3g" % v for k, v in check.err.items()},
           check.near_tie_rows, differ, kept))
    if differ > check.near_tie_rows:
        raise AssertionError("5b: %d captions differ between the kernels and "
                             "their plain versions, with %d near-tie rows to "
                             "explain them" % (differ, check.near_tie_rows))
    report["lhs_bf16"] = dict(
        captions_per_s=caps, seconds=dt, batches=n_batches,
        launches=launches, checked_calls=check.calls,
        checked_max_abs_err=check.err, near_tie_rows=check.near_tie_rows,
        differ_from_checked=differ, phase5_share=kept)
    out = {}
    for name, mode in (("strict", False), ("fast", True)):
        cap = main_captioner(mode, params=fast.params,
                             decode_dtype=torch.bfloat16)
        outs, dt, launches = timed_batches(cap, inputs, n_batches)
        caps = BATCH * n_batches / dt
        if launches != expected_launches(SEQ_LEN * n_batches,
                                     "split" if mode else None, splits=1):
            raise AssertionError("5c %s launches %s" % (name, launches))
        kept = caption_share(outs[0], ref)
        log("  5c decode_dtype=bfloat16 %s: %d batches in %.3f s: %.1f "
            "captions/s (phase 5: %.1f); launches %s; every caption valid; "
            "phase 5's captions kept %.4f"
            % (name, n_batches, dt, caps, base, launches, kept))
        out[name] = dict(captions_per_s=caps, seconds=dt,
                         batches=n_batches, launches=launches,
                         phase5_share=kept)
    report["decode_bf16"] = out
    return report["lhs_bf16"]["launches"]


# ---------------------------------------------------------------------------
# phases 7-8: the eval pipeline
# ---------------------------------------------------------------------------

JOB_FIELDS = ("seqs_vis", "seqs_txt", "seqs_pos", "seqs_all",
              "control_verb", "det_seqs_v", "det_seqs_sr", "verb_list")


def replay_golden_pipeline(report):
    """The JAX pipeline's plans and words (vsrcic_tpu_torch/testdata/
    golden_pipeline.npz, written by tests/torch_parity.py) through the
    kernels: planner tokens, ranks, verb lists and words identical, the
    Sinkhorn soft permutations within 1e-6."""
    import numpy as np
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize
    from vsrcic_tpu_torch.pipelines import CaptionJob, EvalPipeline
    from vsrcic_tpu_torch.utils.params import unflatten
    import torch
    path = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                        "golden_pipeline.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    params = unflatten({k[len("param/"):]: v for k, v in g.items()
                        if k.startswith("param/")})
    cfg = json.loads(str(g["config"]))
    table = json.loads(str(g["verb_table"]))
    batches = []
    while "b%d/control_verb" % len(batches) in g:
        pre = "b%d/" % len(batches)
        batches.append(
            (g[pre + "detections"],
             [CaptionJob(**{f: g[pre + f][p] for f in JOB_FIELDS})
              for p in range(len(g[pre + "control_verb"]))]))
    out = {}
    for name, kw in (("strict", {}),
                     ("fast_bf16", dict(use_fused_attention=True,
                                        use_vocab_topk=True,
                                        table_dtype=torch.bfloat16))):
        cap = ControllableCaptioner(CaptionerConfig(**cfg["captioner"]),
                                    params=params["captioner"],
                                    verb_2_vob_all=table, device="cuda",
                                    **kw)
        pipe = EvalPipeline(cap, params["ssp"], SSPConfig(**cfg["ssp"]),
                            params["sinkhorn"],
                            SinkhornConfig(**cfg["sinkhorn"]),
                            eos_word=int(g["eos_word"]),
                            beam_size=int(g["beam_size"]), device="cuda")
        sinkhorn_normalize.launches = 0
        err = 0.0
        for b, (dets, jobs) in enumerate(batches):
            pre = "%s/b%d/" % (name, b)
            pend = pipe.plan_dispatch(jobs)
            plan = dict(zip(("rank_idx", "rank_valid", "verb_lists"),
                            pipe.plan_finish(pend)))
            plan["preds"] = (
                np.zeros((0, pipe.ssp_cfg.max_len), np.int32)
                if pend.preds is None else pend.preds.numpy())
            for f, x in plan.items():
                if not np.array_equal(x, g[pre + f]):
                    raise AssertionError("golden pipeline %s batch %d: %s "
                                         "differ from JAX" % (name, b, f))
            if pend.P_soft is not None:
                e = float(np.abs(pend.P_soft.numpy() - g[pre + "P_soft"])
                          .max())
                if not e <= 1e-6:
                    raise AssertionError("golden pipeline %s batch %d: "
                                         "P_soft off by %.3g" % (name, b, e))
                err = max(err, e)
            if not np.array_equal(pipe.run_batch(dets, jobs),
                                  g[pre + "words"]):
                raise AssertionError("golden pipeline %s batch %d: run_batch "
                                     "words differ from JAX" % (name, b))
        for b, words in enumerate(pipe.run_stream(batches)):
            if not np.array_equal(words, g["%s/b%d/words" % (name, b)]):
                raise AssertionError("golden pipeline %s batch %d: run_stream"
                                     " words differ from JAX" % (name, b))
        if sinkhorn_normalize.launches == 0:
            raise AssertionError("the golden replay never launched the "
                                 "Sinkhorn kernel")
        log("  golden pipeline %s: planner tokens, ranks, verb lists and "
            "words identical to JAX (%d batches, run_batch and run_stream); "
            "max P_soft diff %.3g" % (name, len(batches), err))
        out[name] = err
    report["golden_pipeline_max_psoft_diff"] = out


def make_jobs(n_jobs, L=10, M=20, D=2048, seed=0):
    """scripts/bench_pipeline.py::make_jobs: per job one or two verbs, each
    with a shared-role pair (a Sinkhorn matrix), a unique role and a V slot;
    random features."""
    import numpy as np
    from vsrcic_tpu_torch.pipelines import CaptionJob
    rng = np.random.RandomState(seed)
    jobs = []
    for p in range(n_jobs):
        control_verb = np.zeros(8)
        seq_v = np.zeros((L, 8))
        seq_sr = np.zeros((L, 8))
        verb_list = np.full((L, 1), -1.0)
        n_verbs = 1 + (p % 2)
        slot = 0
        for vi in range(n_verbs):
            verb = float(1 + (p * 3 + vi) % 150)
            control_verb[vi] = verb
            seq_v[slot:slot + 4, 0] = verb
            seq_sr[slot, 0] = 2.0
            seq_sr[slot + 1, 0] = 2.0
            seq_sr[slot + 2, 0] = 7.0 if vi == 0 else 1.0
            seq_sr[slot + 3, 0] = 25.0
            verb_list[slot + 3, 0] = verb
            slot += 4
        n_used = min(slot, L)
        seqs_all = np.zeros((L, M, D), np.float32)
        seqs_all[:n_used] = rng.rand(n_used, M, D).astype(np.float32)
        jobs.append(CaptionJob(
            seqs_vis=rng.rand(L, D).astype(np.float32),
            seqs_txt=rng.rand(L, 300).astype(np.float32),
            seqs_pos=rng.rand(L, 4).astype(np.float32),
            seqs_all=seqs_all, control_verb=control_verb,
            det_seqs_v=seq_v, det_seqs_sr=seq_sr, verb_list=verb_list))
    return jobs


def pipeline_world(captioner, plain=False, mesh=None):
    """The full-width pipeline around `captioner`: S-SSP coco (hidden 512,
    3 + 3 layers, 2662 verbs) and the 2352-d Sinkhorn net, random weights
    from seeds 1 and 2; under `mesh` (phase 15) on its ranks."""
    import torch
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.pipelines import EvalPipeline
    ssp_cfg, sink_cfg = SSPConfig(dataset="coco"), SinkhornConfig()
    return EvalPipeline(
        captioner, init_ssp_params(torch.Generator().manual_seed(1), ssp_cfg),
        ssp_cfg, init_sinkhorn_params(torch.Generator().manual_seed(2),
                                      sink_cfg),
        sink_cfg, eos_word=3, beam_size=BEAM,
        device=None if mesh else "cuda", plain_sinkhorn=plain, mesh=mesh)


def pipeline_batch(pipe):
    """One batch of 1024 jobs, staged on the card once (stage_seqs_all,
    stage_job_feats), with its detections there too."""
    import numpy as np
    import torch
    jobs = make_jobs(BATCH)
    dets = np.random.RandomState(3).rand(BATCH, N_DET, DET).astype(
        np.float32)
    return (torch.from_numpy(dets).cuda(), jobs, pipe.stage_seqs_all(jobs),
            pipe.stage_job_feats(jobs))


def pipeline_launches():
    """{kernel: (what holds its launch count, the count's attribute)}: its
    wrapper, or what call_sites put in the Sinkhorn wrapper's place; and
    the vocab op's SGEMM launches, which no path of the facade makes."""
    from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize
    from vsrcic_tpu_torch.ops.vocab_topk import split_bf16x3, vocab_topk_lse
    return {"sinkhorn": (sinkhorn_normalize, "launches"),
            "fused_attention": (fused_group_attention, "launches"),
            "vocab_topk": (vocab_topk_lse, "launches"),
            "vocab_split": (split_bf16x3, "launches"),
            "vocab_sgemm": (vocab_topk_lse, "launches_sgemm")}


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before and read
    just after; returns (fn's result, seconds, {kernel: launches})."""
    import torch
    kernels = pipeline_launches()
    torch.cuda.synchronize()
    for obj, attr in kernels.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return res, dt, {name: getattr(obj, attr)
                     for name, (obj, attr) in kernels.items()}


def check_pipeline_launches(launches, n_batches, what):
    """The pipeline's kernels per batch; every vocab launch on the split
    route (the phase-5 captioner: f32 h2, bf16 table at V 10000)."""
    want = {"sinkhorn": 1, "fused_attention": SEQ_LEN, "vocab_topk": SEQ_LEN,
            "vocab_split": SEQ_LEN}
    for name, per_batch in want.items():
        if launches[name] != per_batch * n_batches:
            raise AssertionError("%s: %s launched %d times in %d batches, "
                                 "expected %d per batch"
                                 % (what, name, launches[name], n_batches,
                                    per_batch))


def run_pipeline(report, captioner):
    """Phase 8 on the phase-5 captioner (fast, bf16 tables)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    pipe = pipeline_world(captioner)
    batch = pipeline_batch(pipe)
    dets, jobs, staged, feats = batch
    torch.cuda.synchronize()
    log("  set-up (%d jobs made and staged, planner and Sinkhorn weights "
        "from seeds 1, 2): %.1f s" % (BATCH, time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    list(pipe.run_stream([batch]))                       # warm-up
    n_batches = 3
    outs, dt, launches = counted(
        lambda: list(pipe.run_stream([batch] * n_batches)))
    caps = BATCH * n_batches / dt
    log("  run_stream: %d batches of %d jobs in %.3f s: %.1f captions/s; "
        "launches %s" % (n_batches, BATCH, dt, caps, launches))
    check_pipeline_launches(launches, n_batches, "run_stream")
    words, batch_s, launches_b = counted(
        lambda: pipe.run_batch(dets, jobs, seqs_all=staged,
                               sink_feats=feats))
    log("  run_batch: one batch in %.3f s (%.1f captions/s); launches %s"
        % (batch_s, BATCH / batch_s, launches_b))
    check_pipeline_launches(launches_b, 1, "run_batch")
    for w in outs + [words]:
        if w.shape != (BATCH, SEQ_LEN) or not (
                (w >= 0) & (w < VOCAB)).all():
            raise AssertionError("pipeline words of shape %s out of range"
                                 % (w.shape,))
        if not np.array_equal(w, words):
            raise AssertionError("run_stream and run_batch give different "
                                 "words for the same batch")

    # the plan and the beam of one batch, each ended by a synchronize
    (recons, verb_lists), plan_s, _ = counted(
        lambda: pipe.plan_batch_device(jobs, seqs_all=staged,
                                       sink_feats=feats))
    _, beam_s, _ = counted(lambda: captioner.beam_search_v(
        dets, recons, verb_lists, eos_word=3, beam_size=BEAM).words.cpu())
    log("  one batch in turn: plan %.1f ms, beam %.1f ms; peak memory "
        "%.2f GB" % (1e3 * plan_s, 1e3 * beam_s,
                     torch.cuda.max_memory_allocated() / 1e9))
    report["pipeline"] = dict(
        captions_per_s=caps, seconds=dt, batches=n_batches,
        launches=launches, run_batch_seconds=batch_s,
        run_batch_launches=launches_b, plan_ms=1e3 * plan_s,
        beam_ms=1e3 * beam_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the same batch through the plain versions on the card
    plain = pipeline_world(main_captioner("plain", params=captioner.params),
                           plain=True)
    t0 = time.perf_counter()
    ref_plan = plain.plan_rank_batch(jobs, sink_feats=feats)
    ref_words = plain.run_batch(dets, jobs, seqs_all=staged,
                                sink_feats=feats)
    plain_s = time.perf_counter() - t0
    plan = pipe.plan_rank_batch(jobs, sink_feats=feats)
    for name, a, b in zip(("rank_idx", "rank_valid", "verb_lists"), plan,
                          ref_plan):
        if not np.array_equal(a, b):
            raise AssertionError("pipeline %s differ from the plain "
                                 "versions' on the card" % name)
    share = float((words == ref_words).all(-1).mean())
    log("  plain versions: plan + run_batch %.3f s; ranks identical; "
        "captions identical: %.4f" % (plain_s, share))
    if share < 0.99:
        raise AssertionError("only %.4f of pipeline captions match the plain "
                             "versions" % share)
    report["pipeline"].update(plain_seconds=plain_s, identical_share=share)
    return launches


# ---------------------------------------------------------------------------
# phases 9-10: the trainers
# ---------------------------------------------------------------------------

# the CLI's captioner (CaptionerConfig() defaults) and the training fields'
# layout: 100 detections per image, compact ids (B, 20 steps, 20 regions)
TRAIN_BATCH, TRAIN_DET, TRAIN_LR = 1024, 100, 5e-4
TRAIN_STEPS = 3


def grads_match(what, got, want):
    """Every gradient leaf within rtol 1e-4 / atol 1e-6 of the fixture's;
    returns the largest absolute difference."""
    import numpy as np
    from vsrcic_tpu_torch.utils.params import flatten
    got = {k: v.cpu().numpy() for k, v in flatten(got).items()}
    if sorted(got) != sorted(want):
        raise AssertionError("%s: gradient leaves differ: %s vs %s"
                             % (what, sorted(got), sorted(want)))
    for k, w in want.items():
        if not np.allclose(got[k], w, rtol=1e-4, atol=1e-6):
            raise AssertionError("%s: gradient %s beyond rtol 1e-4 / atol "
                                 "1e-6 (max diff %.3g)" % (
                                     what, k, np.abs(got[k] - w).max()))
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items())


def replay_golden_train(report):
    """Phase 9: vsrcic_tpu_torch/testdata/golden_train.npz (written by
    tests/torch_parity.py from JAX) on the card."""
    import numpy as np
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention
    from vsrcic_tpu_torch.train.captioner import (CaptionerXETrainer,
                                                  scst_loss_fn)
    from vsrcic_tpu_torch.train.common import value_and_grad
    from vsrcic_tpu_torch.utils.params import params_from_jax, unflatten
    path = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                        "golden_train.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    params = unflatten({k[len("param/"):]: v for k, v in g.items()
                        if k.startswith("param/")})
    cfg = CaptionerConfig(**json.loads(str(g["config"])))

    def golden(prefix):
        return {k[len(prefix):]: v for k, v in g.items()
                if k.startswith(prefix)}
    xe = [g["xe/" + k] for k in ("detections", "captions", "ids", "gates")]
    tr = CaptionerXETrainer(cfg, params, lr=float(g["lr"]), device="cuda")
    (_, _), grads = tr.loss_and_grads(*xe)
    xe_err = grads_match("XE step 1", grads, golden("xe/grad/"))
    losses = np.array([tr.step(*xe)[0] for _ in range(3)])
    if not np.allclose(losses, g["xe/losses"], rtol=1e-4, atol=0):
        raise AssertionError("XE losses %s vs JAX %s beyond rtol 1e-4"
                             % (losses, g["xe/losses"]))
    scst = [torch.from_numpy(g["scst/" + k]).cuda() for k in (
        "detections", "groups", "words", "gates", "advantage")]
    loss, grads = value_and_grad(scst_loss_fn, params_from_jax(
        params, "cuda"), cfg, *scst, remat=True)
    if not np.isclose(float(loss), g["scst/loss"], rtol=1e-4, atol=0):
        raise AssertionError("SCST loss %.7g vs JAX %.7g beyond rtol 1e-4"
                             % (float(loss), g["scst/loss"]))
    scst_err = grads_match("SCST", grads, golden("scst/grad/"))
    for fused in (False, True):
        cap = ControllableCaptioner(cfg, params=params, device="cuda",
                                    use_fused_attention=fused)
        fused_group_attention.launches = 0
        words, gates = cap.test(g["scst/detections"], g["scst/groups"])
        if fused and fused_group_attention.launches != cfg.seq_len:
            raise AssertionError("fused greedy launched the kernel %d times"
                                 % fused_group_attention.launches)
        if not (np.array_equal(words.cpu().numpy(), g["greedy/words"])
                and np.array_equal(gates.cpu().numpy(), g["greedy/gates"])):
            raise AssertionError("greedy words/gates (%s) differ from JAX's"
                                 % ("fused kernel" if fused else "strict"))
    log("  golden train: XE step-1 gradients (max diff %.3g) and losses %s "
        "(JAX %s), SCST loss %.7g (JAX %.7g) and gradients (max diff "
        "%.3g) within tolerance; greedy words and gates identical to JAX, "
        "strict and through the fused kernel"
        % (xe_err, losses.tolist(), g["xe/losses"].tolist(), float(loss),
           float(g["scst/loss"]), scst_err))
    report["golden_train"] = dict(
        xe_losses=losses.tolist(), xe_grad_max_diff=xe_err,
        scst_loss=float(loss), scst_grad_max_diff=scst_err)


def train_world(seed=0):
    """Phase 10's batch on the card: detections (B, 100, 2048) standard
    normal, the last 0-60 of each image empty; captions <bos> w... <eos>
    <pad>*; compact ids (B, 20, 20) with 1-20 regions per step, -1 after;
    gate targets in {0, 1}, -1 after the caption; SCST's groups expanded
    from the ids. The features are zero-mean: on all-positive ones
    (|normal|) the first Adam step at lr 5e-4 throws the gate head's
    region-sum logit far off, in the JAX trainer as in this one
    (`python tests/torch_parity.py --xe-full-width` on the CPU: 25.2, then
    486.0), and whether the loss is back below its start after five steps
    depends on the batch."""
    import torch
    from vsrcic_tpu_torch.decode.loops import expand_compact_groups
    b, t, n = TRAIN_BATCH, SEQ_LEN, TRAIN_DET
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen,  # noqa: E731
                                    device="cuda")
    n_real = (n - (rnd(b) * 61).long())                   # 40-100 regions
    det = torch.randn((b, n, DET), generator=gen, device="cuda")
    det = det * (torch.arange(n, device="cuda")[None, :]
                 < n_real[:, None])[..., None]
    length = 5 + (rnd(b) * 14).long()                     # 5-18 words
    pos = torch.arange(t, device="cuda")[None, :]
    words = 4 + (rnd(b, t) * (VOCAB - 4)).long()
    caps = torch.where(pos == 0, 2, torch.where(
        pos <= length[:, None], words, torch.where(
            pos == length[:, None] + 1, 3, 1)))
    regions = 1 + (rnd(b, t) * M_REGIONS).long()
    ids = (rnd(b, t, M_REGIONS) * n_real[:, None, None]).long()
    ids = torch.where(torch.arange(M_REGIONS, device="cuda")
                      < regions[..., None], ids, -1)
    gates = torch.where(pos <= length[:, None] + 1,
                        (rnd(b, t) < 0.3).long(), -1)
    return det, caps, ids, gates, expand_compact_groups(det, ids)


def text_world(det_caps):
    """A text field over V words (4 specials + 9996 'w0000'...) and CIDEr-D
    with the GT captions' document frequency."""
    from vsrcic_tpu_torch.metrics import Cider
    from vsrcic_tpu_torch.text import TextField, ptb_tokenize
    tf = TextField(fix_length=SEQ_LEN)
    tf.build_vocab([" ".join("w%04d" % i for i in range(VOCAB - 4))])
    assert len(tf.vocab) == VOCAB, len(tf.vocab)
    gts = tf.decode(det_caps[:, 1:].cpu().numpy())
    return tf, Cider(gts=ptb_tokenize({i: [c] for i, c in enumerate(gts)})), gts


def compare_rewards(cider, native, caps_s, caps_b, gts):
    """One step's SCST reward both ways: the tokenizer alone, then the
    Python (references' vectors cached, as in a run it scores) and the
    native CIDEr-D scorers on its output; the advantages (sample -
    baseline, float64) must agree within 1e-9."""
    import numpy as np
    from vsrcic_tpu_torch.text import ptb_tokenize
    t0 = time.perf_counter()
    tok = [ptb_tokenize({i: [c] for i, c in enumerate(caps)})
           for caps in (gts, caps_s, caps_b)]
    tok_s = time.perf_counter() - t0
    # the Python scorer caches the references' vectors; a run scored by it
    # would have them from earlier steps, so the timed call is the second
    cider.compute_score_pair(*tok)
    t0 = time.perf_counter()
    r, rb = cider.compute_score_pair(*tok)
    py_s = time.perf_counter() - t0
    keys = range(len(gts))
    t0 = time.perf_counter()
    nr, nrb = native.score_pair(*([t[i][0] for i in keys] for t in tok))
    nat_s = time.perf_counter() - t0
    diff = float(np.abs((nr - nrb) - (r - rb)).max())
    log("  SCST reward of one step, %d captions against %d references: "
        "tokenizer %.1f ms, Python CIDEr-D %.1f ms, native CIDEr-D %.1f ms "
        "(%d threads); advantages agree within %.3g (bar 1e-9), mean "
        "advantage %.5f" % (2 * len(gts), len(gts), 1e3 * tok_s, 1e3 * py_s,
                            1e3 * nat_s, min(os.cpu_count() or 1, 16), diff,
                            float(np.mean(r - rb))))
    if not diff <= 1e-9:
        raise AssertionError("native and Python CIDEr-D advantages differ by "
                             "%.3g" % diff)
    return dict(tokenize_ms=1e3 * tok_s, python_cider_ms=1e3 * py_s,
                native_cider_ms=1e3 * nat_s, max_abs_diff=diff)


def run_trainers(report):
    """Phase 10."""
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.metrics.cider_native import NativeCiderPair
    from vsrcic_tpu_torch.train.captioner import (CaptionerSCSTTrainer,
                                                  CaptionerXETrainer)
    t0 = time.perf_counter()
    cfg = CaptionerConfig()
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    det, caps, ids, gates, groups = train_world()
    tf, cider, gts = text_world(caps)
    torch.cuda.synchronize()
    log("  set-up (CaptionerConfig() weights from seed 0, batch %d, groups "
        "(B, %d, %d, %d) f32): %.1f s" % (TRAIN_BATCH, SEQ_LEN, M_REGIONS,
                                         DET, time.perf_counter() - t0))
    out = {}

    # XE, lean compact path
    torch.cuda.reset_peak_memory_stats()
    xe = CaptionerXETrainer(cfg, params, lr=TRAIN_LR, device="cuda")
    losses = [xe.step(det, caps, ids, gates)[0]]                  # warm-up
    res, dt, launches = counted(lambda: [
        xe.step(det, caps, ids, gates)[0] for _ in range(TRAIN_STEPS)])
    losses += res + [xe.step(det, caps, ids, gates)[0]]
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("  XE (lean): %d steps of %d in %.3f s: %.3f steps/s, %.1f "
        "sequences/s; losses %s; peak memory %.2f GB; launches %s"
        % (TRAIN_STEPS, TRAIN_BATCH, dt, TRAIN_STEPS / dt,
           TRAIN_STEPS * TRAIN_BATCH / dt, ["%.4f" % x for x in losses],
           peak, launches))
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError("XE losses do not fall over five steps: %s"
                             % losses)
    out["xe"] = dict(steps_per_s=TRAIN_STEPS / dt,
                     sequences_per_s=TRAIN_STEPS * TRAIN_BATCH / dt,
                     seconds=dt, losses=losses, peak_mem_gb=peak,
                     launches=launches)
    del xe
    torch.cuda.empty_cache()

    # SCST, fast decode with bf16 tables, greedy baseline every step, the
    # native CIDEr-D reward
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    native = NativeCiderPair(cider)
    native_s = time.perf_counter() - t0
    sc = CaptionerSCSTTrainer(cfg, params, tf, cider, lr=TRAIN_LR,
                              fast_decode=True, table_dtype=torch.bfloat16,
                              baseline="step", native_cider=native,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sc.step(det, groups, gts, gen)                                # warm-up
    res, dt, launches = counted(lambda: [
        sc.step(det, groups, gts, gen) for _ in range(TRAIN_STEPS)])
    per_step = launches["fused_attention"] / TRAIN_STEPS
    log("  SCST (fast_decode, bf16 tables): %d steps of %d in %.3f s: %.3f "
        "steps/s, %.1f sequences/s; (loss, mean advantage) %s; launches %s, "
        "fused attention %.0f per step" % (
            TRAIN_STEPS, TRAIN_BATCH, dt, TRAIN_STEPS / dt,
            TRAIN_STEPS * TRAIN_BATCH / dt, res, launches, per_step))
    if per_step != 2 * SEQ_LEN:
        raise AssertionError("SCST launched the fused kernel %.1f times per "
                             "step, expected %d" % (per_step, 2 * SEQ_LEN))
    if not all(math.isfinite(x) for r in res for x in r):
        raise AssertionError("SCST gave a loss that is not finite: %s" % res)

    # one step in its three parts, each ended by a synchronize
    (sampled, base), dec_s, _ = counted(lambda: sc.decode(det, groups, gen))
    (words, s_gates), _ = sampled
    caps_s, caps_b = sc._decode_caps(words), sc._decode_caps(base)
    t0 = time.perf_counter()
    adv = sc.rewards(caps_s, caps_b, gts)
    rew_s = time.perf_counter() - t0
    _, grad_s, _ = counted(lambda: sc.grad_step(det, groups, words, s_gates,
                                                adv))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("  SCST one step in parts: decode (sample + greedy) %.1f ms, reward "
        "(tokenize + native CIDEr-D of %d captions, host) %.1f ms, grad "
        "%.1f ms; peak memory %.2f GB" % (
            1e3 * dec_s, 2 * TRAIN_BATCH, 1e3 * rew_s, 1e3 * grad_s, peak))
    # the reward's split, on a new decode's captions: the tokenizer caches
    # each caption it has seen, so captions already rewarded would time a
    # warm cache where a step meets new samples
    ((new_words, _), _), base = sc.decode(det, groups, gen)
    reward = compare_rewards(cider, native, sc._decode_caps(new_words),
                             sc._decode_caps(base), gts)
    reward["native_df_load_s"] = native_s

    # the greedy decode through the kernel and through its plain version
    kern, plain = (ControllableCaptioner(
        cfg, params=sc.state.params, use_fused_attention=mode,
        table_dtype=torch.bfloat16, device="cuda") for mode in (True, "plain"))
    w_k, g_k = kern.test(det, groups)
    w_p, g_p = plain.test(det, groups)
    share = float(((w_k == w_p).all(-1) & (g_k == g_p).all(-1)).float()
                  .mean())
    log("  SCST greedy words and gates through the kernel equal the plain "
        "version's on %.4f of captions" % share)
    if share < 0.99:
        raise AssertionError("only %.4f of greedy captions match the plain "
                             "version" % share)
    out["scst"] = dict(steps_per_s=TRAIN_STEPS / dt,
                       sequences_per_s=TRAIN_STEPS * TRAIN_BATCH / dt,
                       seconds=dt, losses=res, launches=launches,
                       fused_launches_per_step=per_step,
                       decode_ms=1e3 * dec_s, reward_ms=1e3 * rew_s,
                       grad_ms=1e3 * grad_s, peak_mem_gb=peak,
                       greedy_identical_share=share, reward=reward)
    report["train"] = out
    return launches


# ---------------------------------------------------------------------------
# phases 11-12: the planner trainers
# ---------------------------------------------------------------------------

# the eval pipeline's per-batch counts (phase 8): 1536 verb groups and 1536
# Sinkhorn pairs per batch of 1024 images
PLAN_GROUPS, PLAN_PAIRS, PLAN_IMAGES, PLAN_LR, PLAN_STEPS = 1536, 1536, 1024, \
    1e-4, 5


def sampled_grads_match(what, grads, g, prefix, cap, scaled):
    """Each gradient leaf's stored entries (every max(1, size // cap)-th,
    as tests/torch_parity.py::grad_sample takes them) within rtol 1e-4 /
    atol 1e-6 of the fixture's, the atol with scaled=True 1e-5 times the
    leaf's largest entry where that exceeds 1 (the 2352-d Sinkhorn net's
    f32 round-off, tests/test_torch_sinkhorn_train.py). Returns the
    largest absolute difference."""
    import numpy as np
    from vsrcic_tpu_torch.utils.params import flatten
    want = {k[len(prefix):]: v for k, v in g.items() if k.startswith(prefix)}
    got = {}
    for k, v in flatten(grads).items():
        flat = v.detach().cpu().numpy().reshape(-1)
        got[k] = flat[::max(1, flat.size // cap)]
    if sorted(got) != sorted(want):
        raise AssertionError("%s: gradient leaves differ" % what)
    worst = 0.0
    for k, w in want.items():
        atol = 1e-6
        if scaled:
            atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        if not np.allclose(got[k], w, rtol=1e-4, atol=atol):
            raise AssertionError("%s: gradient %s beyond rtol 1e-4 / atol "
                                 "%.3g (max diff %.3g)" % (
                                     what, k, atol,
                                     np.abs(got[k] - w).max()))
        worst = max(worst, float(np.abs(got[k] - w).max()))
    return worst


def replay_golden_planners(report):
    """Phase 11: vsrcic_tpu_torch/testdata/golden_planners.npz (written by
    `python tests/torch_parity.py --planners` from JAX) on the card. The
    weights are drawn from the fixture's numpy seeds."""
    import numpy as np
    import torch
    from vsrcic_tpu_torch.models.s_ssp import (SSPConfig, init_ssp_params,
                                               ssp_beam_search)
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.ops.assignment import greedy_assign_device
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize
    from vsrcic_tpu_torch.train.planners import SinkhornTrainer, SSPTrainer
    from vsrcic_tpu_torch.utils.params import seeded_params
    path = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                        "golden_planners.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    cfg = json.loads(str(g["config"]))
    cap = cfg["grad_sample"]
    template = torch.Generator().manual_seed(0)
    ssp_cfg = SSPConfig(**cfg["ssp"])
    ssp = SSPTrainer(ssp_cfg, seeded_params(init_ssp_params(
        template, ssp_cfg), cfg["ssp_seed"]), device="cuda")
    loss, grads = ssp.loss_and_grads(g["ssp/verbs"], g["ssp/det_sr"],
                                     g["ssp/gt_sr"])
    if not np.isclose(float(loss), g["ssp/loss"], rtol=1e-4, atol=0):
        raise AssertionError("S-SSP loss %.7g vs JAX %.7g beyond rtol 1e-4"
                             % (float(loss), g["ssp/loss"]))
    out = {"ssp_loss": float(loss), "ssp_loss_jax": float(g["ssp/loss"]),
           "ssp_grad_max_diff": sampled_grads_match(
               "S-SSP", grads, g, "ssp/grad/", cap, scaled=False)}
    seqs, scores = ssp_beam_search(
        ssp.state.params, ssp_cfg, torch.from_numpy(g["beam/verb"]),
        torch.from_numpy(g["beam/det_sr"]), beam_size=cfg["beam_size"])
    if not np.array_equal(seqs.cpu().numpy(), g["beam/seqs"]):
        raise AssertionError("S-SSP beam sequences differ from JAX's")
    out["beam_score_max_diff"] = float(np.abs(
        scores.cpu().numpy() - g["beam/scores"]).max())
    if not np.allclose(scores.cpu().numpy(), g["beam/scores"], rtol=1e-4,
                       atol=0):
        raise AssertionError("S-SSP beam scores beyond rtol 1e-4 (max diff "
                             "%.3g)" % out["beam_score_max_diff"])
    sink_cfg = SinkhornConfig()
    sink_params = seeded_params(init_sinkhorn_params(template, sink_cfg),
                                cfg["sinkhorn_seed"])
    inputs = g["sink/inputs"].astype(np.float32)
    for norm in ("images", "pairs"):
        tr = SinkhornTrainer(sink_cfg, sink_params,
                             loss_normalization=norm, device="cuda")
        sinkhorn_normalize.launches = 0
        loss, grads = tr.loss_and_grads(inputs, g["sink/tr_locs"],
                                        g["sink/gt_locs"], cfg["n_images"])
        torch.cuda.synchronize()
        if sinkhorn_normalize.launches != 1:
            raise AssertionError("the Sinkhorn trainer's loss launched the "
                                 "kernel %d times, expected 1"
                                 % sinkhorn_normalize.launches)
        want = g["sink/%s/loss" % norm]
        if not np.isclose(float(loss), want, rtol=1e-4, atol=0):
            raise AssertionError("Sinkhorn %s loss %.7g vs JAX %.7g beyond "
                                 "rtol 1e-4" % (norm, float(loss), want))
        out["sinkhorn_%s_loss" % norm] = float(loss)
        out["sinkhorn_%s_loss_jax" % norm] = float(want)
        out["sinkhorn_%s_grad_max_diff" % norm] = sampled_grads_match(
            "Sinkhorn " + norm, grads, g, "sink/%s/grad/" % norm, cap,
            scaled=True)
    for profit, cols in zip(g["assign/profits"], g["assign/cols"]):
        got = greedy_assign_device(torch.from_numpy(profit).cuda())
        if got.device.type != "cuda" or not np.array_equal(
                got.cpu().numpy(), cols):
            raise AssertionError("greedy_assign_device differs from JAX's")
    log("  golden planners: S-SSP loss %.7g (JAX %.7g), gradients within "
        "tolerance (max diff %.3g); beam sequences identical, scores within "
        "%.3g; Sinkhorn through the kernel: 'images' loss %.7g (JAX %.7g), "
        "'pairs' %.7g (JAX %.7g), gradients within tolerance (max diff %.3g, "
        "%.3g); %d greedy assignments identical"
        % (out["ssp_loss"], out["ssp_loss_jax"], out["ssp_grad_max_diff"],
           out["beam_score_max_diff"], out["sinkhorn_images_loss"],
           out["sinkhorn_images_loss_jax"], out["sinkhorn_pairs_loss"],
           out["sinkhorn_pairs_loss_jax"],
           out["sinkhorn_images_grad_max_diff"],
           out["sinkhorn_pairs_grad_max_diff"], len(g["assign/cols"])))
    report["golden_planners"] = out


def ssp_world(seed=0, n=PLAN_GROUPS):
    """Phase 12's S-SSP batch of n groups, as the grid batcher builds it:
    raw verb codes of the 2662 COCO verbs, det_sr of 1-10 distinct roles
    (of 25), gt_sr a permutation of det_sr's nonzero roles."""
    import numpy as np
    rng = np.random.RandomState(seed)
    length = 10
    verbs = rng.randint(1, 2663, (n, 1)).astype(np.float64)
    roles = np.argsort(rng.rand(n, 25), 1)[:, :length] + 1
    k = rng.randint(1, length + 1, n)
    live = np.arange(length)[None, :] < k[:, None]
    det_sr = np.where(live, roles, 0)
    order = np.argsort(np.where(live, rng.rand(n, length), 2.0), 1)
    gt_sr = np.where(live, np.take_along_axis(det_sr, order, 1), 0)
    return verbs, det_sr.astype(np.float64), gt_sr.astype(np.float64)


def sinkhorn_world(seed=0, s=PLAN_PAIRS):
    """Phase 12's Sinkhorn batch of s pairs on the card, as the pair
    builder lays it out: 2-10 slots per pair with uniform [0, 1) features,
    zero rows and 10.0 locations after; tr_locs the sorted slots, gt_locs a
    permutation of their ranks."""
    import torch
    n = 10
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.rand(shape, generator=gen,  # noqa: E731
                                    device="cuda")
    c = 2 + (rnd(s) * (n - 1)).long()                       # 2-10 slots
    live = torch.arange(n, device="cuda")[None, :] < c[:, None]
    inputs = rnd(s, n, 2352) * live[..., None]
    # c distinct slots of a random permutation, sorted, 10.0 after them
    tr_locs = torch.sort(torch.where(live, torch.argsort(rnd(s, n), 1)
                                     .float(), 10.0), 1).values
    perm = torch.argsort(torch.where(live, rnd(s, n), 2.0), 1).float()
    gt_locs = torch.where(live, perm, 10.0)
    return inputs, tr_locs, gt_locs


def timed_steps(step):
    """One warm-up step, then PLAN_STEPS counted ones: (losses of the
    timed steps, seconds, launches, peak memory GB)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    step()
    losses, dt, launches = counted(lambda: [step()
                                            for _ in range(PLAN_STEPS)])
    return losses, dt, launches, torch.cuda.max_memory_allocated() / 1e9


def run_planner_trainers(report):
    """Phase 12."""
    import numpy as np
    import torch
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize_plain
    from vsrcic_tpu_torch.train.planners import SinkhornTrainer, SSPTrainer
    from vsrcic_tpu_torch.utils.params import flatten
    out = {}
    cfg = SSPConfig(dataset="coco")
    tr = SSPTrainer(cfg, init_ssp_params(torch.Generator().manual_seed(1),
                                         cfg), lr=PLAN_LR, device="cuda")
    batch = ssp_world()
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, dt, launches, peak = timed_steps(lambda: tr.step(*batch, gen))
    log("  S-SSP (hidden %d, %d + %d layers, %d verbs, dropout %.1f): %d "
        "steps of %d groups in %.3f s: %.3f steps/s, %.1f groups/s; losses "
        "%s; peak memory %.2f GB; launches %s"
        % (cfg.hidden_size, cfg.encoder_layers, cfg.decoder_layers,
           cfg.verb_size, cfg.dropout, PLAN_STEPS, PLAN_GROUPS, dt,
           PLAN_STEPS / dt, PLAN_STEPS * PLAN_GROUPS / dt,
           ["%.4f" % x for x in losses], peak, launches))
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError("S-SSP losses do not fall: %s" % losses)
    out["ssp"] = dict(steps_per_s=PLAN_STEPS / dt,
                      groups_per_s=PLAN_STEPS * PLAN_GROUPS / dt, seconds=dt,
                      losses=losses, peak_mem_gb=peak, launches=launches)
    del tr
    torch.cuda.empty_cache()

    cfg = SinkhornConfig()
    tr = SinkhornTrainer(cfg, init_sinkhorn_params(
        torch.Generator().manual_seed(2), cfg), lr=PLAN_LR,
        loss_normalization="images", device="cuda")
    batch = sinkhorn_world()
    losses, dt, launches, peak = timed_steps(
        lambda: tr.step(*batch, n_images=PLAN_IMAGES))
    per_step = launches["sinkhorn"] / PLAN_STEPS
    log("  Sinkhorn (2352-d, n %d, %d iterations): %d steps of %d pairs in "
        "%.3f s: %.3f steps/s, %.1f pairs/s; losses %s; peak memory %.2f GB;"
        " Sinkhorn kernel %.0f launch(es) per step (the forward; the "
        "backward replays the plain version)"
        % (cfg.n, cfg.n_iters, PLAN_STEPS, PLAN_PAIRS, dt, PLAN_STEPS / dt,
           PLAN_STEPS * PLAN_PAIRS / dt, ["%.5f" % x for x in losses], peak,
           per_step))
    if per_step != 1:
        raise AssertionError("the Sinkhorn trainer launched the kernel %.1f "
                             "times per step, expected 1" % per_step)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError("Sinkhorn losses do not fall: %s" % losses)

    # one batch's gradients through the kernel and through the plain version
    got = tr.loss_and_grads(*batch, n_images=PLAN_IMAGES)
    want = tr.loss_and_grads(*batch, n_images=PLAN_IMAGES,
                             normalize=sinkhorn_normalize_plain)
    g, w = flatten(got[1]), flatten(want[1])
    worst, strict_misses = 0.0, 0
    for k in w:
        a, b = g[k].cpu().numpy(), w[k].cpu().numpy()
        atol = 1e-5 * max(1.0, float(np.abs(b).max()))
        if not np.allclose(a, b, rtol=1e-4, atol=atol):
            raise AssertionError("Sinkhorn gradient %s through the kernel "
                                 "beyond rtol 1e-4 / atol %.3g of the plain "
                                 "version's (max diff %.3g)"
                                 % (k, atol, np.abs(a - b).max()))
        strict_misses += int((~np.isclose(a, b, rtol=1e-4, atol=1e-6)).sum())
        worst = max(worst, float(np.abs(a - b).max()))
    loss_diff = abs(float(got[0]) - float(want[0]))
    log("  Sinkhorn gradients through the kernel against the plain version's"
        ": max diff %.3g, %d entries beyond rtol 1e-4 / atol 1e-6 (all "
        "within the leaf-scaled atol); losses %.7g and %.7g"
        % (worst, strict_misses, float(got[0]), float(want[0])))
    if not loss_diff <= 1e-4 * abs(float(want[0])):
        raise AssertionError("Sinkhorn loss through the kernel %.7g vs plain "
                             "%.7g" % (float(got[0]), float(want[0])))
    out["sinkhorn"] = dict(steps_per_s=PLAN_STEPS / dt,
                           pairs_per_s=PLAN_STEPS * PLAN_PAIRS / dt,
                           seconds=dt, losses=losses, peak_mem_gb=peak,
                           launches=launches,
                           kernel_launches_per_step=per_step,
                           grad_max_diff_vs_plain=worst,
                           grad_strict_misses_vs_plain=strict_misses)
    report["planners"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 13: the eval CLI
# ---------------------------------------------------------------------------

# the CLI's default widths (feat 2048, encoding 1000, rnn 1000, att 512),
# SSPConfig(dataset="coco") and the 2352-d Sinkhorn net at n 10: 1024 test
# images of one caption each, in two batches of 512
EVAL_FULL = ["--synthetic", "--dataset", "coco", "--synthetic_images", "8192",
             "--limit", "1024", "--batch_size", "512", "--seed", "7"]
EVAL_FLICKR = ["--synthetic", "--dataset", "flickr", "--synthetic_images",
               "512", "--limit", "64", "--batch_size", "32", "--seed", "7",
               "--det", "--gt"]
EVAL_FAST = ["--fused", "--vocab_topk", "--bf16_tables"]
EVAL_MIN_CAPTIONS = 1024
ALL_KERNELS = ("sinkhorn", "fused_attention", "vocab_topk")
# what a CLI run with the kernels launches: the three, and h2's split pass
# (the vocab op's split routes on the padded tables at any V; never the
# SGEMM, which check_cli_launches holds at 0)
CLI_KERNELS = ALL_KERNELS + ("vocab_split",)
# shares of the strict run's captions that 13b's runs must keep: the
# kernels on f32 tables, and the plain versions on bf16 tables, whose
# rounding flips 0.0195 of them at the synthetic world's V 30 (PERF.md §6;
# a cast or layout fault in the tables flips most)
F32_KERNELS_BAR = 0.99
BF16_TABLES_BAR = 0.95


def run_cli(argv, dump):
    """`python -m vsrcic_tpu_torch.cli.eval argv --dump_preds dump` in this
    process (eval_checkpoints.run_captured), with the CLI's own 'decoded'
    line, its captions/s and the dumped captions added."""
    from vsrcic_tpu_torch.cli import eval as eval_cli
    from vsrcic_tpu_torch.tools.eval_checkpoints import run_captured
    res, decoded = run_captured(eval_cli.main, argv, dump)
    return dict(res, decoded=decoded,
                captions_per_s=float(decoded.split("(")[1].split()[0]),
                preds=[json.loads(x)["pred"]
                       for x in res["dump"].splitlines()])


@contextlib.contextmanager
def call_sites(*wraps):
    """The three kernels' call sites in the CLIs' captioner, eval pipeline
    and Sinkhorn trainer, each replaced for the block by the function there
    passed through every wrap(kernel name, fn) in turn. Each wrapper
    carries its function's attributes, `launches` among them: the
    Sinkhorn wrapper counts its launches on what its module's name
    `sinkhorn_normalize` holds, here the trainer's site's wrapper, and
    `counted` reads the count there."""
    import functools
    from vsrcic_tpu_torch.models import api
    from vsrcic_tpu_torch.ops import sinkhorn
    from vsrcic_tpu_torch.pipelines import eval_pipeline
    sites = (("fused_attention", api, "fused_group_attention"),
             ("vocab_topk", api, "vocab_topk_lse"),
             ("sinkhorn", eval_pipeline, "sinkhorn_normalize"),
             ("sinkhorn", sinkhorn, "sinkhorn_normalize"))
    saved = [getattr(m, attr) for _, m, attr in sites]
    try:
        for name, m, attr in sites:
            fn = getattr(m, attr)
            for wrap in wraps:
                fn = functools.update_wrapper(wrap(name, fn), fn)
            setattr(m, attr, fn)
        yield
    finally:
        for (_, m, attr), fn in zip(sites, saved):
            setattr(m, attr, fn)


class IndexWatch:
    """A call_sites wrap. Counts, on the device, the item/ctrl entries that
    the fused op changed (read once, at the end: no synchronisation per
    call), and keeps a copy of each op's first inputs: the shapes and
    values the CLI's main path gives the kernels."""

    def __init__(self):
        self.changed = None
        self.calls = 0
        self.first = {}

    def __call__(self, name, fn):
        def watched(*args, **kw):
            if name not in self.first:
                # copies in the same layout (the padded vocab table's rows
                # stay a pitch of V8 apart)
                self.first[name] = (
                    [a.new_empty_strided(a.shape, a.stride()).copy_(a)
                     if hasattr(a, "clone") else a for a in args],
                    dict(kw))
            if name != "fused_attention":
                return fn(*args, **kw)
            before = [a.clone() for a in args[:2]]
            out = fn(*args, **kw)
            n = sum((a != b).sum() for a, b in zip(args[:2], before))
            self.changed = n if self.changed is None else self.changed + n
            self.calls += 1
            return out
        return watched


class PlainCheck:
    """A call_sites wrap for 13b's checked run: every call runs the kernel
    and its plain version on the same inputs and passes the plain result
    on (of the kernels in `plain_on`; the others' own result), after
    holding the two to phase 3's tolerances (fused attention rtol / atol
    1e-5; vocab values and lse rtol 1e-5 / atol 1e-6, ids exact or a near
    tie; Sinkhorn 1e-6)."""

    def __init__(self, plain_on=ALL_KERNELS):
        self.calls = {name: 0 for name in ALL_KERNELS}
        self.err = {name: 0.0 for name in ALL_KERNELS}
        self.near_tie_rows = 0
        self.plain_on = plain_on

    def __call__(self, name, kernel):
        import torch
        from vsrcic_tpu_torch.ops import fused_attention, sinkhorn, vocab_topk
        plain = {"fused_attention": fused_attention.fused_group_attention_plain,
                 "vocab_topk": vocab_topk.vocab_topk_lse_plain,
                 "sinkhorn": sinkhorn.sinkhorn_normalize_plain}[name]

        def checked(*args, **kw):
            got, want = kernel(*args, **kw), plain(*args, **kw)
            self.calls[name] += 1
            if name == "fused_attention":
                ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                         for g, w in zip(got, want))
                err = max_err(got, want)
            elif name == "vocab_topk":
                pairs = ((got[0], want[0]), (got[2], want[2]))
                ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-6)
                         for g, w in pairs)
                err = max_err(*zip(*pairs))
                if ok:
                    self.near_tie_rows += vocab_near_ties(*args[:3], got,
                                                          want)
            else:
                err = float((got - want).abs().max())
                ok = err <= 1e-6
            self.err[name] = max(self.err[name], err)
            if not ok:
                raise AssertionError("%s, call %d of the CLI's checked run: "
                                     "the kernel is %.3g from its plain "
                                     "version" % (name, self.calls[name],
                                                  err))
            return want if name in self.plain_on else got
        return checked


def vocab_bound(rows, r, v, k, table_bytes):
    """(ms, by): the vocab op's f32 product over the f32 rate, or its
    bytes (h2, the table, bias, outputs) over the HBM rate."""
    flops = 2.0 * rows * r * v
    nbytes = (rows * r * 4 + r * v * table_bytes + v * 4
              + rows * (2 * k + 1) * 4)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_fused(args):
    """The fused kernel on `args` (held stream: at a train CLI's 100 rows
    a launch takes less than the host's interval between launches)
    beside its plain version and its bound."""
    from vsrcic_tpu_torch.ops.fused_attention import (
        fused_group_attention, fused_group_attention_plain)
    bound, by, groups = fused_bound(args)
    return dict(
        shape="rows %d, B %d, L %d, M %d, D %d, A %d, %s" % (
            args[2].shape[0], *args[7].shape, args[2].shape[1],
            str(args[7].dtype).split(".")[1]),
        ms=held_ms(lambda: fused_group_attention(*args))[0],
        plain_ms=cuda_ms(lambda: fused_group_attention_plain(*args),
                         iters=5), bound_ms=bound, bound_by=by,
        distinct_groups=groups)


def time_sinkhorn(x, n_iters, tau):
    """The Sinkhorn kernel on x (held stream) beside its plain version and
    its bound."""
    from vsrcic_tpu_torch.ops.sinkhorn import (sinkhorn_normalize,
                                               sinkhorn_normalize_plain)
    bound, by = sinkhorn_bound(x.shape[0], x.shape[1], n_iters)
    return dict(
        shape="S %d, n %d, %d iterations" % (x.shape[0], x.shape[1],
                                              n_iters),
        ms=held_ms(lambda: sinkhorn_normalize(x, n_iters, tau))[0],
        plain_ms=cuda_ms(lambda: sinkhorn_normalize_plain(x, n_iters, tau),
                         iters=5), bound_ms=bound, bound_by=by)


def log_timings(where, out):
    for name, f in out.items():
        log("  %s at %s (%s): %.4f ms (plain %.4f ms, bound %.4f ms by %s%s)"
            % (name, where, f["shape"], f["ms"], f["plain_ms"],
               f["bound_ms"], f["bound_by"],
               ", library %.4f ms" % f["library_ms"]
               if "library_ms" in f else ""))


def time_cli_kernels(first):
    """Each kernel timed on the inputs the CLI's fast run gave it first
    (IndexWatch.first), beside its plain version, its bound and the
    library's call where there is one. Returns {kernel: fields}."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (vocab_topk_lse,
                                                 vocab_topk_lse_plain)
    out = {"fused_attention": time_fused(first["fused_attention"][0])}
    (h2, w, b), kw = first["vocab_topk"]
    k, planes = kw["k"], kw.get("w_planes")
    route = vocab_route(h2, w, k)
    bound, by = vocab_planes_bound(h2.shape[0], h2.shape[1], w.shape[1], k,
                                   h2.element_size(), w.element_size())
    wf = w.float()

    def library():
        logits = torch.addmm(b, h2, wf)
        return torch.topk(logits, k), torch.logsumexp(logits, -1)
    out["vocab_topk"] = dict(
        shape="rows %d, R %d, V %d (W_t rows %d apart), k %d, %s, %s route"
        % (h2.shape[0], h2.shape[1], w.shape[1], w.stride(0), k,
           str(w.dtype).split(".")[1], route),
        route=route,
        ms=held_ms(lambda: vocab_topk_lse(h2, w, b, k, w_planes=planes))[0],
        plain_ms=cuda_ms(lambda: vocab_topk_lse_plain(h2, w, b, k),
                         iters=5), bound_ms=bound, bound_by=by,
        library_ms=cuda_ms(library))
    out["sinkhorn"] = time_sinkhorn(*first["sinkhorn"][0])
    log_timings("the CLI's first inputs", out)
    return out


def check_cli_launches(launches, what, kernels):
    """Each kernel named in `kernels` launched, every other one not."""
    for name, n in launches.items():
        if (name in kernels) != (n > 0):
            raise AssertionError("%s: %s launched %d times" % (what, name, n))


def replay_golden_eval_cli(report, tmp):
    """13a: the port's CLI on the card from the golden fixture
    (vsrcic_tpu_torch/testdata/golden_eval_cli.npz, written by
    `python tests/torch_parity.py --eval-cli` from the JAX CLI): strict
    flags give JAX's dumps, CIDEr and metric lines exactly; the fast flags
    (the kernels, bf16 tables) give the dumps of JAX's Pallas kernels, ids
    exact."""
    from vsrcic_tpu_torch.tools.eval_checkpoints import (golden_flags,
                                                         lines_match,
                                                         load_golden)
    g = load_golden()
    fast = json.loads(str(g["fast_flags"]))
    out = {}
    for ds in ("coco", "flickr"):
        flags = golden_flags(g, ds, tmp)
        for mode, extra in (("strict", []), ("fast", fast)):
            pre = "%s/%s/" % (ds, mode)
            res, dt, launches = counted(lambda: run_cli(
                flags + extra, os.path.join(tmp, "golden.jsonl")))
            if res["dump"] != str(g[pre + "dump"]):
                raise AssertionError("golden eval CLI %s %s: the dumped "
                                     "captions differ from JAX's" % (ds, mode))
            if res["cider"] != float(g[pre + "cider"]) or not \
                    lines_match(res["metrics"],
                                str(g[pre + "metrics"]).split("\n")):
                raise AssertionError("golden eval CLI %s %s: metric lines "
                                     "differ from JAX's:\n%s" % (
                                         ds, mode, "\n".join(res["metrics"])))
            check_cli_launches(launches, "golden eval CLI %s %s" % (ds, mode),
                               CLI_KERNELS if extra else ("sinkhorn",))
            log("  golden eval CLI %s %s: %d captions and the metric table "
                "identical to JAX's; launches %s" % (ds, mode, res["n"],
                                                     launches))
            out["%s_%s" % (ds, mode)] = dict(n=res["n"], launches=launches,
                                             seconds=dt)
    report["golden_eval_cli"] = out


def time_fields(argv, n=128):
    """Host ms per caption of the eval fields (image + eval detection
    field, as the CLI's loader runs them) on the first n test captions of
    the world `argv` builds."""
    import argparse
    from vsrcic_tpu_torch.cli.common import base_parser, build_world
    from vsrcic_tpu_torch.cli.fields import (make_eval_det_field,
                                             make_image_field)
    opt, _ = base_parser().parse_known_args(argv)
    opt = argparse.Namespace(**vars(opt), fixed_len=10, det=False, gt=False)
    world = build_world(opt)
    image, det = make_image_field(world, opt), make_eval_det_field(world, opt)
    test = world.splits[2][:n]
    t0 = time.perf_counter()
    for ex in test:
        image.preprocess(ex.image)
        det.preprocess(ex.detection)
    ms = 1e3 * (time.perf_counter() - t0) / len(test)
    log("  host fields: %.2f ms per caption (%d captions, image + eval "
        "detection field at D %d)" % (ms, len(test), opt.feat_dim))
    return dict(ms_per_caption=ms, captions=len(test))


def run_eval_cli(report, tmp):
    """13b: the CLI at full width from seeded checkpoints: strict; the fast
    flags with every kernel call held to its plain version, whose result
    goes on (the checked run); `--fused --vocab_topk` on f32 tables; the
    fast flags (the main path). Then a short Flickr --det --gt run with the
    fast flags."""
    from vsrcic_tpu_torch.tools.eval_checkpoints import (checkpoint_trees,
                                                         write)
    t0 = time.perf_counter()
    trees = checkpoint_trees(EVAL_FULL)
    vocab = int(trees["captioner"]["cfg"]["vocab_size"])
    ckpt = write(os.path.join(tmp, "coco"), trees)
    log("  seeded full-width checkpoints (vocab V = %d) written in %.1f s"
        % (vocab, time.perf_counter() - t0))
    runs = {}
    # the strict run first: it takes the full-width shapes' first-call
    # costs; the fast run last, warm
    for name, extra in (("strict", []), ("checked", EVAL_FAST),
                        ("f32_kernels", ["--fused", "--vocab_topk"]),
                        ("fast", EVAL_FAST)):
        watch = IndexWatch()
        check = PlainCheck() if name == "checked" else None
        with call_sites(*filter(None, (check, watch))):
            res, dt, launches = counted(lambda: run_cli(
                EVAL_FULL + ckpt + extra, os.path.join(tmp, name + ".jsonl")))
        changed = None if watch.changed is None else int(watch.changed)
        log("  %s: %s (whole CLI run %.1f s); launches %s" % (
            name, res["decoded"], dt, launches))
        for line in res["metrics"]:
            log("    " + line)
        if res["n"] < EVAL_MIN_CAPTIONS or len(res["preds"]) != res["n"]:
            raise AssertionError("the %s CLI run decoded %d captions"
                                 % (name, res["n"]))
        check_cli_launches(launches, "eval CLI " + name,
                           CLI_KERNELS if extra else ("sinkhorn",))
        if changed:
            raise AssertionError("the fused kernel changed %d item/ctrl "
                                 "entries in the CLI run" % changed)
        if not math.isfinite(res["cider"]):
            raise AssertionError("CIDEr is not finite: %s" % res["cider"])
        runs[name] = dict(res, seconds=dt, launches=launches,
                          fused_calls_watched=watch.calls,
                          item_ctrl_changed=changed)
        if check is not None:
            log("  checked: every kernel call against its plain version: "
                "calls %s, max_abs_err %s, vocab near-tie rows %d"
                % (check.calls, {k: "%.3g" % v for k, v in check.err.items()},
                   check.near_tie_rows))
            runs[name].update(calls_checked=check.calls,
                              max_abs_err=check.err,
                              near_tie_rows=check.near_tie_rows)
        if name == "fast":
            first = watch.first

    def differ(a, b):
        return sum(x != y for x, y in zip(runs[a]["preds"], runs[b]["preds"]))

    n = len(runs["strict"]["preds"])
    diffs = {"fast_vs_checked": differ("fast", "checked"),
             "f32_kernels_vs_strict": differ("f32_kernels", "strict"),
             "checked_vs_strict": differ("checked", "strict"),
             "fast_vs_strict": differ("fast", "strict")}
    shares = {k: 1 - d / n for k, d in diffs.items()}
    log("  captions that agree, of %d (V = %d): %s" % (
        n, vocab, ", ".join("%s %.4f" % kv for kv in shares.items())))
    # the kernels' captions are the plain versions' on the same tables,
    # but where a near tie in the logits (checked as vocab_near_ties does)
    # lets them part
    if diffs["fast_vs_checked"] > runs["checked"]["near_tie_rows"]:
        raise AssertionError(
            "%d of the eval CLI's captions differ between the kernels and "
            "their plain versions, with %d near-tie rows to explain them"
            % (diffs["fast_vs_checked"], runs["checked"]["near_tie_rows"]))
    for key, bar in (("f32_kernels_vs_strict", F32_KERNELS_BAR),
                     ("checked_vs_strict", BF16_TABLES_BAR)):
        if shares[key] < bar:
            raise AssertionError("%s: %.4f of the captions agree, below %.2f"
                                 % (key, shares[key], bar))
    report["eval_cli_kernels"] = time_cli_kernels(first)
    for name, f in report["eval_cli_kernels"].items():
        f["max_abs_err"] = runs["checked"]["max_abs_err"][name]
    report["eval_cli_fields"] = time_fields(EVAL_FULL)
    ckpt_f = write(os.path.join(tmp, "flickr"), checkpoint_trees(EVAL_FLICKR))
    watch = IndexWatch()
    with call_sites(watch):
        res, dt, launches = counted(lambda: run_cli(
            EVAL_FLICKR + ckpt_f + EVAL_FAST,
            os.path.join(tmp, "flickr.jsonl")))
    log("  flickr --det --gt fast: %s; launches %s; item/ctrl changed %s"
        % (res["decoded"], launches, int(watch.changed)))
    check_cli_launches(launches, "eval CLI flickr", CLI_KERNELS)
    if int(watch.changed) or res["n"] == 0:
        raise AssertionError("the Flickr CLI run failed its checks")
    for r in list(runs.values()) + [res]:
        del r["dump"], r["preds"]
    report["eval_cli"] = dict(runs, shares=shares, differ=diffs, vocab=vocab,
                              flickr=dict(res, seconds=dt,
                                          launches=launches))
    return runs["fast"]["launches"]


def run_phase13(report):
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        log("[13a] golden eval CLI replay")
        replay_golden_eval_cli(report, tmp)
        log("[13b] eval CLI at full width (synthetic COCO, seeded "
            "checkpoints)")
        return run_eval_cli(report, tmp)


# ---------------------------------------------------------------------------
# phase 14: the train CLIs
# ---------------------------------------------------------------------------

# the CLIs' default widths (feat 2048, encoding 1000, rnn 1000, att 512,
# SSPConfig() 512/512/3, the 2352-d Sinkhorn net) on synthetic COCO: 512
# training images of one caption each, 64 for validation and 64 for test
TRAIN_CLI_FULL = ["--synthetic", "--dataset", "coco", "--synthetic_images",
                  "512", "--seed", "7"]
TRAIN_CLI_STEPS = 5
TRAIN_CLI_CHECKED_STEPS = 2
SCST_BATCH = 100


@contextlib.contextmanager
def step_sizes(cls):
    """For the block, cls.step records the leading size of its first
    argument (the step's groups or pairs) and steps."""
    sizes = []
    step = cls.step

    def recording(self, first, *a, **kw):
        sizes.append(int(first.shape[0]))
        return step(self, first, *a, **kw)

    cls.step = recording
    try:
        yield sizes
    finally:
        cls.step = step


def replay_golden_train_cli(report, tmp):
    """14a: the port's XE and Sinkhorn CLIs on the card from the golden
    fixture (vsrcic_tpu_torch/testdata/golden_train_cli.npz, the JAX CLIs'
    runs): per-step losses within rtol 1e-4, saved weights within rtol
    1e-4 / atol 1e-6, XE's validation lines equal; the Sinkhorn runs
    through the kernel, once per step."""
    from vsrcic_tpu_torch.cli import train, train_sinkhorn
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    golden = g.load_golden()
    mains = {"train": train.main, "train_sinkhorn": train_sinkhorn.main}
    out = {}
    for run, (cli, _, _) in g.RUNS.items():
        root = os.path.join(tmp, "golden", run)
        argv = g.golden_flags(golden, run, root)
        res, dt, launches = counted(lambda: g.run_captured(mains[cli], argv))
        diffs = g.check_run("golden %s on the card" % run, res,
                            g.saved_params(root, run),
                            *g.golden_run(golden, run))
        expect_launches("golden " + run, launches, {
            "sinkhorn": len(res["losses"])} if cli == "train_sinkhorn"
            else {})
        log("  golden %s: losses %s within rtol %g of JAX's (worst %.3g), "
            "weights within %.3g%s; launches %s" % (
                run, ["%.5f" % x for x in res["losses"]], g.LOSS_RTOL,
                diffs["loss_rel_diff"], diffs["param_max_diff"],
                ", validation lines equal" if res["lines"] else "",
                launches))
        out[run] = dict(diffs, losses=res["losses"], launches=launches,
                        seconds=dt)
    report["golden_train_cli"] = out


def run_train_cli(name, main, argv, tmp, *wraps):
    """One train CLI run in this process with `--log_dir`, each kernel's
    launches counted and every wrap on the kernels' call sites: its
    run_captured result with the per-step seconds from the journal's `t`
    deltas (the first step excluded: its record starts the clock), the
    CLI's epoch line, launches and whole-run seconds."""
    import numpy as np
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    log_dir = os.path.join(tmp, "log", name)
    with call_sites(*wraps):
        res, dt, launches = counted(lambda: g.run_captured(
            main, argv + ["--log_dir", log_dir]))
    if res["steps"] != list(range(len(res["steps"]))) or not res["steps"]:
        raise AssertionError("%s: journal steps %s" % (name, res["steps"]))
    if not all(map(math.isfinite, res["losses"])):
        raise AssertionError("%s: a loss is not finite: %s"
                             % (name, res["losses"]))
    epoch = [ln for ln in res["out"] if ln.startswith("epoch 0 ")]
    res.update(step_s=np.diff(res["t"]).tolist(), epoch_line=epoch[0],
               launches=launches, seconds=dt)
    log("  %s: %d steps, losses %s, %.4f s per step after the first; %s; "
        "launches %s; whole run %.1f s" % (
            name, len(res["losses"]), ["%.4f" % x for x in res["losses"]],
            float(np.mean(res["step_s"])), epoch[0], launches, dt))
    return res


def expect_launches(name, launches, want):
    if any(n != want.get(k, 0) for k, n in launches.items()):
        raise AssertionError("%s: launches %s, predicted %s"
                             % (name, launches, want))


def run_train_clis(report, tmp):
    """14b: the four train CLIs at their default widths on synthetic COCO
    (XE, SCST --fast_decode from its checkpoint, S-SSP, Sinkhorn), then
    the eval CLI's fast flags from their three checkpoints."""
    import numpy as np
    from vsrcic_tpu_torch.cli import (train, train_region_sort,
                                      train_sinkhorn)
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    from vsrcic_tpu_torch.train import planners
    root = os.path.join(tmp, "full")
    base = TRAIN_CLI_FULL + ["--checkpoint_path", root]
    steps = ["--max_steps", str(TRAIN_CLI_STEPS), "--max_epochs", "1"]
    checked_steps = ["--max_steps", str(TRAIN_CLI_CHECKED_STEPS),
                     "--max_epochs", "1"]
    scst = ["--sample_rl", "--fast_decode", "--batch_size", str(SCST_BATCH)]
    out = {}

    def rate(res, sizes):
        per = np.asarray(sizes[1:len(res["t"])], np.float64)
        return float(per.sum() / np.sum(res["step_s"]))

    with g.first_staged_batch() as staged:
        xe = run_train_cli("XE", train.main, base + steps + [
            "--batch_size", str(SCST_BATCH)], tmp)
    staged_bytes = g.check_staged(staged)
    expect_launches("XE", xe["launches"], {})
    if sum(" val CIDEr " in ln for ln in xe["out"]) != 1:
        raise AssertionError("XE printed no single validation table")
    xe["sequences_per_s"] = SCST_BATCH / float(np.mean(xe["step_s"]))
    log("  XE: %.1f sequences/s; the first staged batch equals the host's "
        "(%d bytes in %d arrays, bit for bit)" % (
            xe["sequences_per_s"], staged_bytes, len(staged["host"])))
    out["xe"] = xe

    # SCST checked: every fused call beside its plain version, whose result
    # goes on; item/ctrl watched for writes
    check, watch = PlainCheck(), IndexWatch()
    res = run_train_cli("SCST checked", train.main,
                        base + scst + checked_steps, tmp, check, watch)
    n = 2 * SEQ_LEN * TRAIN_CLI_CHECKED_STEPS
    if check.calls["fused_attention"] != n or int(watch.changed):
        raise AssertionError("SCST checked: %d fused calls checked (want "
                             "%d), item/ctrl entries changed %d" % (
                                 check.calls["fused_attention"], n,
                                 int(watch.changed)))
    log("  SCST checked: %d fused calls within phase 3's tolerances of the "
        "plain version (worst %.3g); no item/ctrl entry changed"
        % (n, check.err["fused_attention"]))
    out["scst_checked"] = dict(res, calls_checked=check.calls,
                               max_abs_err=check.err)
    fused_err = check.err["fused_attention"]

    watch = IndexWatch()
    res = run_train_cli("SCST", train.main, base + scst + steps, tmp, watch)
    if not any(ln.startswith("restored XE best") for ln in res["out"]):
        raise AssertionError("SCST restored no XE checkpoint")
    expect_launches("SCST", res["launches"], {
        "fused_attention": 2 * SEQ_LEN * TRAIN_CLI_STEPS})
    if int(watch.changed):
        raise AssertionError("SCST: the fused kernel changed %d item/ctrl "
                             "entries" % int(watch.changed))
    res["sequences_per_s"] = SCST_BATCH / float(np.mean(res["step_s"]))
    log("  SCST --fast_decode: %.1f sequences/s" % res["sequences_per_s"])
    out["scst"] = res
    fused_first = watch.first["fused_attention"][0]

    with step_sizes(planners.SSPTrainer) as sizes:
        res = run_train_cli("S-SSP", train_region_sort.main, base + steps,
                            tmp)
    expect_launches("S-SSP", res["launches"], {})
    res.update(groups=sizes, groups_per_s=rate(res, sizes))
    log("  S-SSP: %s groups per step, %.1f groups/s" % (
        sizes, res["groups_per_s"]))
    out["ssp"] = res

    check = PlainCheck()
    res = run_train_cli("Sinkhorn checked", train_sinkhorn.main,
                        base + checked_steps, tmp, check)
    if check.calls["sinkhorn"] != TRAIN_CLI_CHECKED_STEPS:
        raise AssertionError("Sinkhorn checked: %d calls checked"
                             % check.calls["sinkhorn"])
    log("  Sinkhorn checked: %d calls within 1e-6 of the plain version "
        "(worst %.3g)" % (check.calls["sinkhorn"], check.err["sinkhorn"]))
    out["sinkhorn_checked"] = dict(res, calls_checked=check.calls,
                                   max_abs_err=check.err)
    sink_err = check.err["sinkhorn"]

    watch = IndexWatch()
    with step_sizes(planners.SinkhornTrainer) as sizes:
        res = run_train_cli("Sinkhorn", train_sinkhorn.main, base + steps,
                            tmp, watch)
    expect_launches("Sinkhorn", res["launches"],
                    {"sinkhorn": TRAIN_CLI_STEPS})
    res.update(pairs=sizes, pairs_per_s=rate(res, sizes))
    log("  Sinkhorn: %s pairs per step, %.1f pairs/s" % (
        sizes, res["pairs_per_s"]))
    out["sinkhorn"] = res
    sink_first = watch.first["sinkhorn"][0]

    ckpt = ["--captioner_ckpt", os.path.join(root, "coco_cap", "exp_rl_last"),
            "--ssp_ckpt", os.path.join(root, "coco_s_ssp", "model-tr"),
            "--sinkhorn_ckpt", os.path.join(root, "coco_sinkhorn",
                                            "model-sh")]
    watch = IndexWatch()
    with call_sites(watch):
        res, dt, launches = counted(lambda: run_cli(
            TRAIN_CLI_FULL + ["--limit", "64"] + ckpt + EVAL_FAST,
            os.path.join(tmp, "train_cli_eval.jsonl")))
    check_cli_launches(launches, "eval CLI from the trained checkpoints",
                       CLI_KERNELS)
    if int(watch.changed) or res["n"] < 64 or not math.isfinite(
            res["cider"]):
        raise AssertionError("the eval CLI from the trained checkpoints "
                             "failed its checks: %s" % res["decoded"])
    log("  eval CLI from the three trained checkpoints (fast flags): %s; "
        "CIDEr %.4f; launches %s" % (res["decoded"], res["cider"],
                                     launches))
    del res["dump"], res["preds"]
    out["eval"] = dict(res, seconds=dt, launches=launches)

    for r in out.values():
        r.pop("out", None)
    timings = {"fused_attention": time_fused(fused_first),
               "sinkhorn": time_sinkhorn(*sink_first)}
    timings["fused_attention"]["max_abs_err"] = fused_err
    timings["sinkhorn"]["max_abs_err"] = sink_err
    log_timings("the train CLIs' first inputs", timings)
    report["train_cli"] = out
    report["train_cli_kernels"] = timings
    return {"train_cli_scst": out["scst"]["launches"],
            "train_cli_sinkhorn": out["sinkhorn"]["launches"]}


def run_phase14(report):
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        log("[14a] golden train CLI replay (XE, Sinkhorn COCO and Flickr)")
        replay_golden_train_cli(report, tmp)
        log("[14b] train CLIs at full width (synthetic COCO)")
        return run_train_clis(report, tmp)


# ---------------------------------------------------------------------------
# phase 15: data parallelism (vsrcic_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

# counts that do not divide by 2: pipeline jobs, S-SSP groups, Sinkhorn pairs
P15_JOBS, P15_GROUPS, P15_PAIRS = BATCH - 1, PLAN_GROUPS + 1, PLAN_PAIRS + 1
P15_STEPS = 2
P15_TOL = dict(rtol=1e-4, atol=1e-6)
# the share of a trainer's weights that must be within P15_TOL of the
# single-device run's at world 2; every other entry within 2 lr a step:
# where a gradient is round-off of zero, Adam's normalisation turns the two
# sums of it into steps of up to lr (tests/test_torch_parallel_planners.py)
P15_PARAM_SHARE = 0.99
# the share of captions the world-2 beam and pipeline must keep of the
# single-device batch's: a rank's block is decoded by products of its own
# shape, whose rounding can flip a vocab near tie
P15_CAPTION_SHARE = 0.99


def p15_rank(out_dir):
    """Phase 15's paths on one rank: NCCL at world 1 in this process, or
    gloo at world 2 on two ranks sharing the card; each path beside its
    single-device run on the same rank. World 1 must give the single-device
    results bit for bit; at world 2 each rank's beam block must be the
    single-device program on that block bit for bit. Writes this rank's
    results to out_dir/rank<r>.json."""
    import torch
    from vsrcic_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = torch.distributed.get_world_size()
    mesh = make_mesh(world, devices=["cuda:0"] * world)
    out = dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
               beam=p15_beam(mesh), pipeline=p15_pipeline(mesh),
               train=p15_trainers(mesh))
    with open(os.path.join(out_dir, "rank%d.json" % mesh.rank), "w") as f:
        json.dump(out, f)


def p15_same(what, mesh, got, want):
    """World 1: every tensor of `got` equal to want's, bit for bit."""
    import torch
    if mesh.size == 1 and not all(torch.equal(g, w)
                                  for g, w in zip(got, want)):
        raise AssertionError("%s: NCCL at world 1 differs from the "
                             "single-device run" % what)


def p15_captions(what, mesh, got, want):
    """The number of captions (best beams) that differ; at world 1 none
    may, at world 2 at most 1 - P15_CAPTION_SHARE of them."""
    import numpy as np
    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                 for x in (got, want))
    differ = int((got != want).any(-1).sum())
    if differ and (mesh.size == 1 or differ > (1 - P15_CAPTION_SHARE)
                   * len(want)):
        raise AssertionError("%s: %d of %d captions differ from the "
                             "single-device batch's" % (what, differ,
                                                        len(want)))
    return differ


def p15_watched(watch, what):
    if watch.changed is not None and int(watch.changed):
        raise AssertionError("%s: the fused kernel changed %d item/ctrl "
                             "entries" % (what, int(watch.changed)))


def p15_beam(mesh):
    """The sharded beam at bench.py's shapes against the single-device
    beam, and each rank's block against the single-device program run on
    that block alone."""
    import torch
    from vsrcic_tpu_torch.parallel import sharded_beam_search_v
    cap = main_captioner()
    det, grp, vl = main_inputs()
    kw = dict(eos_word=3, beam_size=BEAM)
    sharded_beam_search_v(cap, mesh, det, grp, vl, **kw)       # warm-up
    watch = IndexWatch()
    with call_sites(watch):
        res, dt, launches = counted(
            lambda: sharded_beam_search_v(cap, mesh, det, grp, vl, **kw))
    p15_watched(watch, "sharded beam")
    expect_launches("rank %d: sharded beam" % mesh.rank, launches,
                    {"fused_attention": SEQ_LEN, "vocab_topk": SEQ_LEN,
                     "vocab_split": SEQ_LEN})
    check_result(res)
    lo, hi = mesh.bounds(BATCH)
    own = cap.beam_search_v(det[lo:hi], grp[lo:hi], vl[lo:hi], **kw)
    if not all(torch.equal(o, r[lo:hi]) for o, r in zip(own, res)):
        raise AssertionError("rank %d: its beam block differs from the "
                             "single-device program on that block"
                             % mesh.rank)
    ref, ref_s, _ = counted(lambda: cap.beam_search_v(det, grp, vl, **kw))
    p15_same("sharded beam", mesh, res, ref)
    differ = p15_captions("sharded beam", mesh, res.words[:, 0],
                          ref.words[:, 0])
    return dict(launches=launches, ms=1e3 * dt, single_ms=1e3 * ref_s,
                captions_differing=differ, rows=hi - lo)


def p15_pipeline(mesh):
    """EvalPipeline(mesh=...).run_batch on P15_JOBS of phase 8's jobs
    against the single-device pipeline's."""
    import numpy as np
    import torch
    cap = main_captioner()
    pipe, single = pipeline_world(cap, mesh=mesh), pipeline_world(cap)
    jobs = make_jobs(P15_JOBS)
    dets = torch.from_numpy(np.random.RandomState(3).rand(
        P15_JOBS, N_DET, DET).astype(np.float32)).cuda()
    single.run_batch(dets, jobs)                               # warm-up
    watch = IndexWatch()
    with call_sites(watch):
        words, dt, launches = counted(lambda: pipe.run_batch(dets, jobs))
    p15_watched(watch, "sharded pipeline")
    check_pipeline_launches(launches, 1, "rank %d: sharded pipeline"
                            % mesh.rank)
    ref, ref_s, _ = counted(lambda: single.run_batch(dets, jobs))
    if words.shape != (P15_JOBS, SEQ_LEN):
        raise AssertionError("sharded pipeline words %s" % (words.shape,))
    p15_same("sharded pipeline", mesh, [torch.from_numpy(words)],
             [torch.from_numpy(ref)])
    differ = p15_captions("sharded pipeline", mesh, words, ref)
    return dict(launches=launches, ms=1e3 * dt, single_ms=1e3 * ref_s,
                captions_differing=differ, jobs=P15_JOBS)


def p15_checksum(params, mesh):
    """Every rank's float64 checksum of `params`; raises unless equal."""
    import torch
    from vsrcic_tpu_torch.parallel.mesh import all_gather_blocks
    from vsrcic_tpu_torch.utils.params import flatten
    total = sum(float(v.double().sum()) for v in flatten(params).values())
    sums = all_gather_blocks(torch.tensor([total], dtype=torch.float64,
                                          device=mesh.device), mesh).tolist()
    if len(set(sums)) != 1:
        raise AssertionError("the ranks' parameters differ: checksums %s"
                             % sums)
    return total


def p15_compare(what, mesh, got, want, lr):
    """(losses, params, seconds) of the mesh run and of the single-device
    run: world 1 bit for bit; world 2 losses within rtol 1e-4 and the
    weights as P15_PARAM_SHARE says."""
    import numpy as np
    import torch
    from vsrcic_tpu_torch.utils.params import flatten
    (g_loss, g_par, g_s), (w_loss, w_par, w_s) = got, want
    g_par, w_par = flatten(g_par), flatten(w_par)
    checksum = p15_checksum(g_par, mesh)
    diff = max(float((g_par[k] - w_par[k]).abs().max()) for k in w_par)
    close = sum(int(torch.isclose(g_par[k], w_par[k], **P15_TOL).sum())
                for k in w_par) / sum(v.numel() for v in w_par.values())
    if mesh.size == 1:
        if g_loss != w_loss or diff != 0.0:
            raise AssertionError("%s: NCCL at world 1 gives losses %s and "
                                 "weights %.3g off the single-device run's "
                                 "(%s)" % (what, g_loss, diff, w_loss))
    elif not (np.allclose(g_loss, w_loss, rtol=1e-4, atol=0)
              and close >= P15_PARAM_SHARE
              and diff <= 2 * lr * P15_STEPS):
        raise AssertionError("%s at world %d: losses %s vs %s, %.4f of the "
                             "weights within rtol 1e-4 / atol 1e-6, max diff "
                             "%.3g" % (what, mesh.size, g_loss, w_loss,
                                       close, diff))
    return dict(losses=g_loss, single_losses=w_loss, max_param_diff=diff,
                share_within_tol=close, checksum=checksum,
                ms_per_step=1e3 * g_s / P15_STEPS,
                single_ms_per_step=1e3 * w_s / P15_STEPS)


def p15_steps(step):
    """P15_STEPS steps, ended by a synchronize: (losses, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(P15_STEPS)]
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def p15_trainers(mesh):
    """XE and SCST (fast decode, bf16 tables, native CIDEr-D) at batch
    1024, S-SSP on P15_GROUPS groups and Sinkhorn on P15_PAIRS pairs, each
    under the mesh and alone from the same weights."""
    import torch
    from vsrcic_tpu_torch.metrics.cider_native import NativeCiderPair
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.parallel.mesh import replicate, shard_batch
    from vsrcic_tpu_torch.train import (CaptionerSCSTTrainer,
                                        CaptionerXETrainer, SinkhornTrainer,
                                        SSPTrainer)
    out = {}
    cfg = CaptionerConfig()
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    det, caps, ids, gates, groups = train_world()

    def trainer(cls, m, *a, **kw):
        return cls(*a, mesh=m, device=None if m else "cuda", **kw)

    # warm-up: the timed runs below meet no first-call set-up
    trainer(CaptionerXETrainer, None, cfg, params).step(det, caps, ids,
                                                        gates)

    runs = {}
    for m in (mesh, None):
        tr = trainer(CaptionerXETrainer, m, cfg, replicate(params, mesh)
                     if m else params, lr=TRAIN_LR)
        batch = shard_batch((det, caps, ids, gates), m) if m else (
            det, caps, ids, gates)
        losses, dt = p15_steps(lambda i: tr.step(*batch)[0])
        runs[m is None] = losses, tr.state.params, dt
        del tr
    out["xe"] = p15_compare("XE", mesh, runs[False], runs[True], TRAIN_LR)

    tf, cider, gts = text_world(caps)
    native = NativeCiderPair(cider)
    sc = {m is None: trainer(CaptionerSCSTTrainer, m, cfg,
                             replicate(params, mesh) if m else params, tf,
                             cider, lr=TRAIN_LR, fast_decode=True,
                             table_dtype=torch.bfloat16, native_cider=native)
          for m in (mesh, None)}
    # the grad step on one single-device trajectory, then whole steps
    gen = torch.Generator(device="cuda").manual_seed(7)
    (words, s_gates), _ = sc[True].decode(det, groups, gen)[0]
    adv = sc[True].rewards(sc[True]._decode_caps(words),
                           sc[True]._decode_caps(
                               sc[True].decode(det, groups)[1]), gts)
    trainer(CaptionerSCSTTrainer, None, cfg, params, tf, cider).grad_step(
        det, groups, words, s_gates, adv)                      # warm-up
    for single in (False, True):
        losses, dt = p15_steps(lambda i: sc[single].grad_step(
            det, groups, words, s_gates, adv))
        runs[single] = losses, sc[single].state.params, dt
    out["scst_grad"] = p15_compare("SCST grad step", mesh, runs[False],
                                   runs[True], TRAIN_LR)
    trainer(CaptionerSCSTTrainer, None, cfg, params, tf, cider,
            fast_decode=True, table_dtype=torch.bfloat16,
            native_cider=native).step(det, groups, gts, gen)   # warm-up
    watch = IndexWatch()
    for single in (False, True):
        with call_sites(watch):
            (losses, dt), _, launches = counted(lambda: p15_steps(
                lambda i: sc[single].step(det, groups, gts, torch.Generator(
                    device="cuda").manual_seed(i))))
        if not single:
            p15_watched(watch, "sharded SCST")
            expect_launches("rank %d: SCST steps" % mesh.rank, launches,
                            {"fused_attention": 2 * SEQ_LEN * P15_STEPS})
            scst_launches = launches
        runs[single] = losses, sc[single].state.params, dt
    if mesh.size == 1:      # a rank's own stream at world 1 is the seed's
        out["scst"] = p15_compare("SCST", mesh, runs[False], runs[True],
                                  TRAIN_LR)
    else:
        p15_checksum(sc[False].state.params, mesh)
        if not all(math.isfinite(x) for r in runs[False][0] for x in r):
            raise AssertionError("SCST at world 2: %s" % (runs[False][0],))
        out["scst"] = dict(losses=runs[False][0],
                           ms_per_step=1e3 * runs[False][2] / P15_STEPS,
                           single_ms_per_step=1e3 * runs[True][2]
                           / P15_STEPS)
    out["scst"]["launches"] = scst_launches
    del sc

    scfg = SSPConfig(dataset="coco")
    sparams = init_ssp_params(torch.Generator().manual_seed(1), scfg)
    batch = ssp_world(n=P15_GROUPS)
    trainer(SSPTrainer, None, scfg, sparams).step(*batch, gen)  # warm-up
    for m in (mesh, None):
        tr = trainer(SSPTrainer, m, scfg, replicate(sparams, mesh)
                     if m else sparams, lr=PLAN_LR)
        losses, dt = p15_steps(lambda i: tr.step(*batch, torch.Generator(
            device="cuda").manual_seed(i)))
        runs[m is None] = losses, tr.state.params, dt
    out["ssp"] = p15_compare("S-SSP", mesh, runs[False], runs[True], PLAN_LR)
    out["ssp"]["groups"] = P15_GROUPS

    kcfg = SinkhornConfig()
    kparams = init_sinkhorn_params(torch.Generator().manual_seed(2), kcfg)
    batch = sinkhorn_world(s=P15_PAIRS)
    trainer(SinkhornTrainer, None, kcfg, kparams).step(
        *batch, n_images=PLAN_IMAGES)                          # warm-up
    for m in (mesh, None):
        tr = trainer(SinkhornTrainer, m, kcfg, replicate(kparams, mesh)
                     if m else kparams, lr=PLAN_LR,
                     loss_normalization="images")
        (losses, dt), _, launches = counted(lambda: p15_steps(
            lambda i: tr.step(*batch, n_images=PLAN_IMAGES)))
        runs[m is None] = losses, tr.state.params, dt
        if m is not None:
            expect_launches("rank %d: Sinkhorn steps" % mesh.rank, launches,
                            {"sinkhorn": P15_STEPS})
            sink_launches = launches
    out["sinkhorn"] = p15_compare("Sinkhorn", mesh, runs[False], runs[True],
                                  PLAN_LR)
    out["sinkhorn"].update(pairs=P15_PAIRS, launches=sink_launches)
    return out


def p15_world(devices, tmp):
    """p15_rank on one rank per device (parallel.launch.run); every
    rank's results."""
    from vsrcic_tpu_torch.parallel.launch import run
    out_dir = os.path.join(tmp, "world%d" % len(devices))
    os.makedirs(out_dir)
    run(p15_rank, devices, out_dir)
    ranks = []
    for r in range(len(devices)):
        with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    return ranks


def p15_log(ranks):
    for res in ranks:
        tag = "  rank %d of %d (%s)" % (res["rank"], res["size"],
                                        res["backend"])
        for path in ("beam", "pipeline"):
            p = res[path]
            log("%s %s: %.1f ms (single device %.1f ms), captions differing "
                "from the single-device batch %d, launches %s"
                % (tag, path, p["ms"], p["single_ms"],
                   p["captions_differing"], p["launches"]))
        for name, t in res["train"].items():
            log("%s %s: losses %s (single device %s), %.1f ms a step (single"
                " device %.1f), weights max diff %s, within rtol 1e-4 / atol "
                "1e-6 %s%s" % (
                    tag, name, ["%.6g" % x if isinstance(x, float) else x
                                for x in t["losses"]],
                    t.get("single_losses", "-"), t["ms_per_step"],
                    t["single_ms_per_step"], t.get("max_param_diff", "-"),
                    t.get("share_within_tol", "-"),
                    "; launches %s" % t["launches"] if "launches" in t
                    else ""))


def p15_clis(tmp):
    """The four train CLIs and the eval CLI (fast flags) at
    --data_parallel 1 (NCCL, world 1) against --data_parallel 0 on
    synthetic COCO at their default widths, 2 steps each: the same
    per-step losses, printed lines and dumped captions, bit for bit."""
    from vsrcic_tpu_torch.cli import train, train_region_sort, train_sinkhorn
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    steps = ["--max_steps", str(P15_STEPS), "--max_epochs", "1"]
    runs = (("XE", train.main, ["--batch_size", str(SCST_BATCH)]),
            ("SCST", train.main, ["--sample_rl", "--fast_decode",
                                  "--batch_size", str(SCST_BATCH)]),
            ("S-SSP", train_region_sort.main, []),
            ("Sinkhorn", train_sinkhorn.main, []))
    out = {}
    for dp in ("0", "1"):
        root = os.path.join(tmp, "cli_dp" + dp)
        base = TRAIN_CLI_FULL + ["--checkpoint_path", root] + steps
        res = {}
        for name, main, flags in runs:
            res[name] = g.run_captured(main, base + flags + [
                "--log_dir", os.path.join(root, "log", name),
                "--data_parallel", dp])
        ckpt = ["--captioner_ckpt", os.path.join(root, "coco_cap",
                                                 "exp_rl_last"),
                "--ssp_ckpt", os.path.join(root, "coco_s_ssp", "model-tr"),
                "--sinkhorn_ckpt", os.path.join(root, "coco_sinkhorn",
                                                "model-sh")]
        res["eval"] = run_cli(TRAIN_CLI_FULL + ["--limit", "64"] + ckpt
                              + EVAL_FAST + ["--data_parallel", dp],
                              os.path.join(tmp, "eval_dp%s.jsonl" % dp))
        out[dp] = res
    for name, _, _ in runs:
        a, b = out["0"][name], out["1"][name]
        if a["losses"] != b["losses"] or a["lines"] != b["lines"]:
            raise AssertionError("%s CLI at --data_parallel 1: losses %s and "
                                 "%d lines, at 0: %s and %d lines" % (
                                     name, b["losses"], len(b["lines"]),
                                     a["losses"], len(a["lines"])))
        log("  %s CLI at --data_parallel 1 (NCCL) and 0: losses %s, %d "
            "printed lines, equal" % (name, ["%.5f" % x for x in b["losses"]],
                                      len(b["lines"])))
    a, b = out["0"]["eval"], out["1"]["eval"]
    if a["dump"] != b["dump"] or a["metrics"] != b["metrics"]:
        raise AssertionError("the eval CLI at --data_parallel 1 dumps or "
                             "prints otherwise than at 0")
    log("  eval CLI (fast flags) at --data_parallel 1 and 0: %d captions "
        "dumped and %d metric lines, equal; %s" % (
            b["n"], len(b["metrics"]), b["decoded"]))
    return {name: dict(losses=out["1"][name]["losses"])
            for name, _, _ in runs}


def run_phase15(report):
    """Phase 15: (a) NCCL at world 1, (b) gloo on two ranks sharing the
    card; the launches of each path on rank 0 of (b)."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log("[15a] NCCL at world 1: the sharded beam, pipeline and trainers "
            "against the single-device runs, bit for bit")
        out["world1"] = p15_world(["cuda:0"], tmp)
        p15_log(out["world1"])
        out["world1_clis"] = p15_clis(tmp)
        log("[15b] gloo, two ranks sharing the card")
        import torch
        torch.cuda.empty_cache()    # the ranks' memory, not this process's
        t0 = time.perf_counter()
        out["world2"] = p15_world(["cuda:0", "cuda:0"], tmp)
        out["world2_seconds"] = time.perf_counter() - t0
        p15_log(out["world2"])
    report["parallel"] = out
    r0 = out["world2"][0]
    return {"parallel_beam": r0["beam"]["launches"],
            "parallel_pipeline": r0["pipeline"]["launches"],
            "parallel_train_scst": r0["train"]["scst"]["launches"],
            "parallel_train_sinkhorn": r0["train"]["sinkhorn"]["launches"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vsrcic_tpu_torch.ops import _build

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("[1] card: %s | torch %s, CUDA %s | TF32 matmul=%s cudnn=%s"
        % (card, torch.__version__, torch.version.cuda,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    # phase 2 (the checked build compiles beside it, for phase 3m)
    pending = None
    if not any(a.startswith("--") for a in sys.argv[1:]) or (
            "--memcheck" in sys.argv[1:]):
        import threading
        pending = threading.Thread(target=_build.build, args=(True,))
        pending.start()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log("[2] kernels built in %.1f s (nvcc %.1f s)"
        % (build_s, _build.last_build_seconds))
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())
    report["build_seconds"] = build_s
    t0 = time.perf_counter()
    _build.host_library("cider_scorer")
    report["scorer_build_seconds"] = time.perf_counter() - t0
    log("    native CIDEr-D scorer (csrc/cider_scorer.cpp, c++) built in "
        "%.1f s" % report["scorer_build_seconds"])
    check_packed_reader(report)

    # phase 3
    log("[3] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = {}
    if "--vocab-bf16" in sys.argv[1:]:
        check_vocab(gen, kernels)
        check_vocab_bf16(gen, kernels)
        check_vocab_nonfinite(gen, kernels)
        log("[5] beam path (bench.py shapes, fast configuration)")
        _, fast, inputs, ref = run_main_path(report)
        log("[5b-5c] the beam's bf16 modes")
        run_bf16_paths(report, fast, inputs, ref)
        log("[5d] the beam on f32 tables")
        run_f32_tables(report, fast, inputs)
        report["kernels"] = kernels
        write_report(report)
        print(card)
        print(json.dumps({k: report[k] for k in ("main_path", "lhs_bf16",
                                                  "decode_bf16",
                                                  "f32_tables")}
                         | {k: kernels[k] for k in ("vocab_topk",
                                                    "vocab_split",
                                                    "vocab_topk_bf16")}))
        print_device_line()
        return 0
    if "--memcheck" in sys.argv[1:]:
        log("[3m] memory check (checked build, guarded buffers, every plan)")
        check_memcheck(gen, kernels, pending)
        report["kernels"] = kernels
        write_report(report)
        print(card)
        print(json.dumps({"memcheck": {k: kernels["memcheck"][k] for k in (
            "by_kernel", "by_row", "checked_ms", "sweep_seconds")}}))
        print_device_line()
        return 0
    if "--fused" in sys.argv[1:]:
        check_fused(gen, kernels)
        report["kernels"] = kernels
        write_report(report)
        print(card)
        print(json.dumps({"fused_attention": kernels["fused_attention"]}))
        print_device_line()
        return 0
    if "--sinkhorn" in sys.argv[1:]:
        check_sinkhorn(gen, kernels)
        print(card)
        print(json.dumps({"sinkhorn": kernels["sinkhorn"]}))
        return 0
    if "--pipeline" in sys.argv[1:]:
        log("[8] eval pipeline at full width (run_stream, run_batch)")
        run_pipeline(report, main_captioner())
        print(card)
        print(json.dumps({"pipeline": report["pipeline"]}))
        return 0
    if "--train" in sys.argv[1:]:
        log("[9] golden trainers replay")
        replay_golden_train(report)
        log("[10] trainers at full width (XE, SCST fast decode)")
        run_trainers(report)
        write_report(report)
        print(card)
        print(json.dumps({"train": report["train"]}))
        print_device_line()
        return 0
    if "--eval" in sys.argv[1:]:
        run_phase13(report)
        write_report(report)
        print(card)
        print(json.dumps({"golden_eval_cli": report["golden_eval_cli"],
                          "eval_cli": report["eval_cli"],
                          "eval_cli_kernels": report["eval_cli_kernels"]}))
        print_device_line()
        return 0
    if "--train-cli" in sys.argv[1:]:
        run_phase14(report)
        write_report(report)
        print(card)
        print(json.dumps({"golden_train_cli": report["golden_train_cli"],
                          "train_cli_kernels": report["train_cli_kernels"]}))
        print_device_line()
        return 0
    if "--parallel" in sys.argv[1:]:
        by_path = run_phase15(report)
        write_report(report)
        print(card)
        print(json.dumps({"launches_by_path": by_path}))
        print_device_line()
        return 0
    if "--planners" in sys.argv[1:]:
        log("[11] golden planner trainers replay")
        replay_golden_planners(report)
        log("[12] planner trainers at full width (S-SSP, Sinkhorn)")
        run_planner_trainers(report)
        write_report(report)
        print(card)
        print(json.dumps({"golden_planners": report["golden_planners"],
                          "planners": report["planners"]}))
        print_device_line()
        return 0
    check_fused(gen, kernels)
    check_vocab(gen, kernels)
    check_vocab_bf16(gen, kernels)
    check_vocab_nonfinite(gen, kernels)
    check_sinkhorn(gen, kernels)

    # phase 3m
    log("[3m] memory check (checked build, guarded buffers, every plan)")
    check_memcheck(gen, kernels, pending)

    # phase 4
    log("[4] golden replay")
    replay_golden(report)
    replay_golden_bf16(report)

    # phases 5-6
    log("[5] beam path (bench.py shapes, fast configuration)")
    beam_launches, fast, inputs, ref = run_main_path(report)
    log("[5b-5c] the beam's bf16 modes")
    bf16_launches = run_bf16_paths(report, fast, inputs, ref)
    log("[5d] the beam on f32 tables")
    f32_launches, f32_lhs_launches = run_f32_tables(report, fast, inputs)
    del fast, inputs, ref

    # phase 7
    log("[7] golden pipeline replay")
    replay_golden_pipeline(report)

    # phase 8
    log("[8] eval pipeline at full width (run_stream, run_batch)")
    launches = run_pipeline(report, main_captioner())

    # phases 9-10
    log("[9] golden trainers replay")
    replay_golden_train(report)
    log("[10] trainers at full width (XE, SCST fast decode)")
    train_launches = run_trainers(report)

    # phases 11-12
    log("[11] golden planner trainers replay")
    replay_golden_planners(report)
    log("[12] planner trainers at full width (S-SSP, Sinkhorn)")
    sink_launches = run_planner_trainers(report)

    # phase 13: the slice's main path, the eval CLI
    cli_launches = run_phase13(report)
    by_path = {"beam": beam_launches, "beam_lhs_bf16": bf16_launches,
               "beam_f32_tables": f32_launches,
               "beam_f32_tables_lhs_bf16": f32_lhs_launches,
               "pipeline": launches,
               "train_scst": train_launches, "train_sinkhorn": sink_launches,
               "eval_cli": cli_launches}

    # phase 14: the train CLIs
    by_path.update(run_phase14(report))

    # phase 15: data parallelism
    by_path.update(run_phase15(report))

    rows = []
    for name, src, replaces in (
            ("fused_attention", "vsrcic_tpu_torch/csrc/fused_attention.cu",
             "vsrcic_tpu/ops/fused_attention.py:35"),
            ("vocab_topk", "vsrcic_tpu_torch/csrc/vocab_topk.cu",
             "vsrcic_tpu/ops/vocab_topk.py:47"),
            ("sinkhorn", "vsrcic_tpu_torch/csrc/sinkhorn.cu",
             "scripts/ab_sinkhorn.py:28")):
        k = kernels[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": cli_launches[name],
               "launches_by_path": {p: n.get(name, 0)
                                    for p, n in by_path.items()},
               "max_abs_err": k["max_abs_err"],
               "max_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        row.update({f: v for f, v in k.items()
                    if f.startswith(("beam1_", "eval_", "rows100_", "f32_"))})
        if name == "vocab_topk":
            # ms, bound: the beam's shape, where it takes the split route
            # (the CLI's V 30 too, through its padded table: cli_ms)
            row.update(kernel_route=k["route"],
                       cuda_core_bound_ms=k["cuda_core_bound_ms"],
                       sgemm_ms=k["sgemm_ms"], launches_split_by_path={
                           p: n.get("vocab_split", 0)
                           for p, n in by_path.items()},
                       nonfinite_table=kernels["vocab_nonfinite_facade"])
        row.update({"cli_" + f: v for f, v in
                    report["eval_cli_kernels"][name].items()})
        row.update({"train_cli_" + f: v for f, v in
                    report["train_cli_kernels"].get(name, {}).items()})
        rows.append(row)
    # the bf16-operand kernel runs on the beam under VSRCIC_VOCAB_LHS_BF16=1
    # (phase 5b), its main path; no CLI flag selects it, as in JAX
    k = kernels["vocab_topk_bf16"]
    rows.append({
        "name": "vocab_topk_bf16", "route": "cuda",
        "kernel_route": k["route"],
        "source": "vsrcic_tpu_torch/csrc/vocab_topk.cu",
        "replaces": "vsrcic_tpu/ops/vocab_topk.py:47 (lhs_dtype=bfloat16)",
        "launches": bf16_launches["vocab_topk_bf16"],
        "launches_by_path": {p: n.get("vocab_topk_bf16", 0)
                             for p, n in by_path.items()},
        "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "library_kind": k["library_kind"]})
    # the split pass runs inside every split-route vocab launch: the beam
    # (phase 5), the pipeline and the sharded beam
    k = kernels["vocab_split"]
    rows.append({
        "name": "vocab_split", "route": "cuda", "kernel_route": "split",
        "source": "vsrcic_tpu_torch/csrc/vocab_topk.cu",
        "replaces": "vsrcic_tpu/ops/vocab_topk.py:47 (its f32 h2, split "
                    "exactly into three bf16 planes)",
        "launches": beam_launches["vocab_split"],
        "launches_by_path": {p: n.get("vocab_split", 0)
                             for p, n in by_path.items()},
        "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    # the f32 tables' routes: the beam on f32 tables (phase 5d) and under
    # VSRCIC_VOCAB_LHS_BF16=1 on them, their main paths; the eval CLI's
    # --fused --vocab_topk run takes "split9" too (13b); times held at the
    # beam's shape beside the SGEMM on the same values
    k = kernels["vocab_topk"]
    for route, lhs, n in (("split9", "float32", f32_launches),
                          ("split_w", "bfloat16", f32_lhs_launches)):
        key = "vocab_topk_" + route
        rows.append({
            "name": key, "route": "cuda", "kernel_route": route,
            "source": "vsrcic_tpu_torch/csrc/vocab_topk.cu",
            "replaces": "vsrcic_tpu/ops/vocab_topk.py:47 (table_dtype="
                        "float32, lhs_dtype=%s)" % lhs,
            "launches": n[key],
            "launches_by_path": {p: c.get(key, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": k["worst_by_route"][route]["abs"],
            "max_err": k["worst_by_route"][route]["abs"],
            "ms": k["held_ms"][route], "plain_ms": k["plain_f32_ms"],
            "bound_ms": k["bounds_by_route"][route],
            "bound_by": k["bound_by_route"][route],
            "library_ms": k["library_f32_ms"], "sgemm_ms": k["sgemm_ms"],
            "cuda_core_bound_ms": k["cuda_core_bound_f32_ms"]})
    # the memory check's counts (phase 3m) over the CUDA kernels behind
    # each row, and the row's call on the default and the checked build
    mc = kernels["memcheck"]
    for row in rows:
        row["memcheck"] = {f: mc["by_row"][row["name"]][f]
                           for f in ("cases", "launches", "faults")}
        row["memcheck_kernels"] = mc["by_row"][row["name"]]["kernels"]
        timed = mc["checked_ms"][ROW_CALL[row["name"]]]
        row["checked_ms"] = timed["checked_ms"]
        row["default_ms_beside_checked"] = timed["ms"]
    report["kernels"] = kernels
    write_report(report)
    print(card)
    print(json.dumps({"kernels": rows}))
    print_device_line()
    return 0


def write_report(report):
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)


def print_device_line():
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
