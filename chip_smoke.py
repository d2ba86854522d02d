#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vsrcic_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --sinkhorn   # phases 1-2 and the Sinkhorn check
    python3 chip_smoke.py --pipeline   # phases 1-2 and 8

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the TF32 settings
     (both off: the JAX reference runs its f32 products at 'highest');
  2. build the kernels from vsrcic_tpu_torch/csrc/ and report the build time
     and what ptxas reports (registers, shared memory, spills);
  3. hold each kernel against its plain PyTorch version on the card: at the
     full-width shapes of the path, at ragged shapes, on the vocab tie cases
     and, for the Sinkhorn kernel, at every (S, n) of SINK_CASE_S x
     SINK_CASE_N (the boundaries of its packing); time the kernel, its plain
     version and, where one PyTorch call computes the same function, that
     call. The Sinkhorn kernel must also give the same bits as its
     arithmetic replayed step by step in PyTorch; a few microseconds long,
     it is timed with the stream held while its launches are enqueued, and
     by the profiler;
  4. replay the beam's golden fixture (JAX results) through the kernel path;
  5. drive the beam, `ControllableCaptioner.beam_search_v` at the bench.py
     shapes (batch 1024, beam 5, fused attention, vocab top-k, bf16
     tables): one warm-up and three timed batches, with every kernel's launch
     count reset just before and read just after;
  6. run the same batch through the plain versions on the card and compare;
  7. replay the eval pipeline's golden fixture (JAX plans and words) through
     the kernels, strict and fast captioner;
  8. drive the eval pipeline, `EvalPipeline.run_stream` and `run_batch`, at
     full width (scripts/bench_pipeline.py's jobs, 1024 per batch: planner
     hidden 512 with 2662 verbs, the 2352-d Sinkhorn net, the phase-5
     captioner): one warm-up and three timed batches through run_stream and
     one through run_batch, each with the launch counts reset just before
     and read just after; the plan and beam times of one batch; the same
     batch through the plain versions on the card, compared.

Prints the kernels' JSON line, then, last, the device JSON line. Details go
to chiprun_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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


def max_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_inputs(gen, rows, b, m, d, a, table, n_real=None, beam=BEAM):
    import torch
    dev = "cuda"
    det = torch.rand((b, L_GROUPS, m, d), generator=gen, device=dev)
    det[:, :, n_real or m:] = 0.0           # padded regions are all zero
    det[:, :, 0, :] *= (torch.rand((b, L_GROUPS, 1), generator=gen,
                                   device=dev) < 0.9)  # some empty regions
    proj = torch.randn((b, L_GROUPS, m, a), generator=gen, device=dev)
    item = (torch.arange(rows, device=dev) // beam).clamp(max=b - 1)
    ctrl = torch.randint(0, L_GROUPS, (rows,), generator=gen, device=dev)
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


def check_fused(gen, report):
    import torch
    from vsrcic_tpu_torch.ops.fused_attention import (
        fused_group_attention as kern, fused_group_attention_plain as plain)
    worst = 0.0
    cases = []
    for table in (torch.bfloat16, torch.float32):
        for m in (M_REGIONS, M_PAD):
            cases.append(("full", ROWS, BATCH, m, DET, ATT, table,
                          M_REGIONS))
    for table in (torch.bfloat16, torch.float32):
        cases.append(("ragged", 37, 9, 5, 100, 36, table, 4))
        cases.append(("ragged", 13, 4, 7, 130, 50, table, 7))
    timed = None
    for name, rows, b, m, d, a, table, n_real in cases:
        args = fused_inputs(gen, rows, b, m, d, a, table, n_real)
        index = [t.clone() for t in args[:2]]
        got = kern(*args)
        torch.cuda.synchronize()
        # the plain version gathers with item/ctrl; a kernel that wrote them
        # would show up there as an out-of-range index, not as a mismatch
        if not all(torch.equal(t, c) for t, c in zip(args[:2], index)):
            raise AssertionError("fused attention changed its item/ctrl "
                                 "inputs (%s)" % name)
        want = plain(*args)
        err = max_err(got, want)
        ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                 for g, w in zip(got, want))
        log("  fused_attention %-6s rows=%d B=%d M=%d D=%d A=%d %s: "
            "max_abs_err=%.3g" % (name, rows, b, m, d, a,
                                  str(table).split(".")[1], err))
        if not ok:
            raise AssertionError("fused attention disagrees with its plain "
                                 "version beyond 1e-5 (%s)" % name)
        worst = max(worst, err)
        if name == "full" and table == torch.bfloat16 and m == M_PAD:
            timed = args
    ms = cuda_ms(lambda: kern(*timed))
    plain_ms = cuda_ms(lambda: plain(*timed), iters=5)
    bound_ms, bound_by, groups = fused_bound(timed)
    log("  fused_attention at rows=%d M=%d bf16: %.4f ms (plain %.4f ms, "
        "bound %.4f ms by %s, %d distinct groups)"
        % (ROWS, M_PAD, ms, plain_ms, bound_ms, bound_by, groups))
    report["fused_attention"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, distinct_groups=groups)


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
    logits = h2[rows] @ w.float() + b
    for i, r in enumerate(rows.tolist()):
        kid = got[1][r].long()
        lk = logits[i, kid]
        pv = want[0][r]
        if not torch.all((lk - pv).abs() <= 1e-5 * pv.abs()):
            raise AssertionError("vocab top-k row %d: ids %s vs plain %s are "
                                 "not a near tie" % (r, got[1][r].tolist(),
                                                     want[1][r].tolist()))
    return int(rows.numel())


def check_vocab(gen, report):
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import (
        vocab_topk_lse as kern, vocab_topk_lse_plain as plain)
    worst = 0.0

    def compare(h2, w, b, k, exact_ids):
        nonlocal worst
        got = kern(h2, w, b, k)
        torch.cuda.synchronize()
        want = plain(h2, w, b, k)
        for g, wnt, name in ((got[0], want[0], "vals"),
                             (got[2], want[2], "lse")):
            if not torch.allclose(g, wnt, rtol=1e-5, atol=1e-6):
                raise AssertionError("vocab top-k %s beyond rtol 1e-5: %.3g"
                                     % (name, float((g - wnt).abs().max())))
        worst = max(worst, float((got[0] - want[0]).abs().max()),
                    float((got[2] - want[2]).abs().max()))
        if exact_ids:
            if not torch.equal(got[1], want[1]):
                raise AssertionError("vocab top-k ids differ on a tie case")
            return 0
        return vocab_near_ties(h2, w, b, got, want)

    for i, (h2, w, b, k) in enumerate(vocab_tie_cases(gen)):
        for table in (torch.float32, torch.bfloat16):
            compare(h2, w.to(table).contiguous(), b, k, exact_ids=True)
        log("  vocab_topk tie case %d rows=%d R=%d V=%d k=%d: ids exact"
            % (i, h2.shape[0], h2.shape[1], w.shape[1], k))
    for rows, r, v, k in ((37, 77, 1001, 5), (3, 1000, 130, 1),
                          (101, 129, 257, 16)):
        h2 = torch.randn((rows, r), generator=gen, device="cuda")
        w = torch.randn((r, v), generator=gen, device="cuda") / r ** 0.5
        b = torch.randn((v,), generator=gen, device="cuda")
        for table in (torch.float32, torch.bfloat16):
            n = compare(h2, w.to(table).contiguous(), b, k, exact_ids=False)
            log("  vocab_topk ragged rows=%d R=%d V=%d k=%d %s: near-tie "
                "rows %d" % (rows, r, v, k, str(table).split(".")[1], n))
    # full width: h2 like the LSTM's output, out_fc weights xavier-normal
    h2 = torch.tanh(torch.randn((ROWS, RNN), generator=gen, device="cuda"))
    w = torch.randn((RNN, VOCAB), generator=gen, device="cuda") * (
        2.0 / (RNN + VOCAB)) ** 0.5
    b = 0.01 * torch.randn((VOCAB,), generator=gen, device="cuda")
    near = {}
    tables = {}
    for table in (torch.float32, torch.bfloat16):
        wt = w.to(table).contiguous()
        tables[table] = wt
        near[str(table)] = compare(h2, wt, b, BEAM, exact_ids=False)
        log("  vocab_topk full rows=%d R=%d V=%d k=%d %s: near-tie rows %d"
            % (ROWS, RNN, VOCAB, BEAM, str(table).split(".")[1],
               near[str(table)]))
    wt = tables[torch.bfloat16]
    ms = cuda_ms(lambda: kern(h2, wt, b, BEAM))
    plain_ms = cuda_ms(lambda: plain(h2, wt, b, BEAM), iters=5)
    wf = wt.float()

    def library():  # one product, top-k and logsumexp (timed only)
        logits = torch.addmm(b, h2, wf)
        return torch.topk(logits, BEAM), torch.logsumexp(logits, -1)
    library_ms = cuda_ms(library)
    flops = 2.0 * ROWS * RNN * VOCAB
    nbytes = (ROWS * RNN * 4 + RNN * VOCAB * wt.element_size() + VOCAB * 4
              + ROWS * (2 * BEAM + 1) * 4)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    log("  vocab_topk at rows=%d bf16: %.4f ms (plain %.4f ms, library "
        "%.4f ms, bound %.4f ms by operations, %.1f f32 TFLOP/s)"
        % (ROWS, ms, plain_ms, library_ms, bound_ms, flops / ms / 1e9))
    report["vocab_topk"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms, near_tie_rows=near)


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


def main_captioner(mode=True, params=None):
    """The bench.py configuration; mode True runs the kernels, "plain" their
    plain versions (same bf16 tables)."""
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    return ControllableCaptioner(
        CaptionerConfig(**MAIN_CFG), params=params, seed=0,
        verb_2_vob_all=VERBS, use_fused_attention=mode, use_vocab_topk=mode,
        table_dtype=torch.bfloat16, device="cuda")


def run_main_path(report):
    import torch
    from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse
    t0 = time.perf_counter()
    fast = main_captioner()
    detections, det_groups, verb_list = main_inputs()
    torch.cuda.synchronize()
    log("  set-up (weights from seed 0, inputs): %.1f s"
        % (time.perf_counter() - t0))

    def run(cap):
        return cap.beam_search_v(detections, det_groups, verb_list,
                                 eos_word=3, beam_size=BEAM)

    run(fast)                                   # warm-up
    torch.cuda.synchronize()
    n_batches = 3
    fused_group_attention.launches = 0
    vocab_topk_lse.launches = 0
    t0 = time.perf_counter()
    outs = [run(fast) for _ in range(n_batches)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fused_attention": fused_group_attention.launches,
                "vocab_topk": vocab_topk_lse.launches}
    caps = BATCH * n_batches / dt
    log("  main path: %d batches of %d captions (beam %d) in %.3f s: %.1f "
        "captions/s; launches %s" % (n_batches, BATCH, BEAM, dt, caps,
                                     launches))
    for name, n in launches.items():
        if n != SEQ_LEN * n_batches:
            raise AssertionError("%s launched %d times in %d batches, "
                                 "expected %d per batch"
                                 % (name, n, n_batches, SEQ_LEN))
    for res in outs:
        check_result(res)
    for res in outs[1:]:
        if not (torch.equal(res.words, outs[0].words)
                and torch.equal(res.gates, outs[0].gates)):
            raise AssertionError("repeated batches decode differently")
    report["main_path"] = dict(captions_per_s=caps, seconds=dt,
                               batches=n_batches, launches=launches,
                               peak_mem_gb=torch.cuda.max_memory_allocated()
                               / 1e9)

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
    return launches


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


def pipeline_world(captioner, plain=False):
    """The full-width pipeline around `captioner`: S-SSP coco (hidden 512,
    3 + 3 layers, 2662 verbs) and the 2352-d Sinkhorn net, random weights
    from seeds 1 and 2."""
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
        sink_cfg, eos_word=3, beam_size=BEAM, device="cuda",
        plain_sinkhorn=plain)


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
    from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse
    return {"sinkhorn": sinkhorn_normalize,
            "fused_attention": fused_group_attention,
            "vocab_topk": vocab_topk_lse}


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before and read
    just after; returns (fn's result, seconds, {kernel: launches})."""
    import torch
    kernels = pipeline_launches()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return res, dt, {name: k.launches for name, k in kernels.items()}


def check_pipeline_launches(launches, n_batches, what):
    want = {"sinkhorn": 1, "fused_attention": SEQ_LEN, "vocab_topk": SEQ_LEN}
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

    # phase 2
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log("[2] kernels built in %.1f s (nvcc %.1f s)"
        % (build_s, _build.last_build_seconds))
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())
    report["build_seconds"] = build_s

    # phase 3
    log("[3] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = {}
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
    check_fused(gen, kernels)
    check_vocab(gen, kernels)
    check_sinkhorn(gen, kernels)

    # phase 4
    log("[4] golden replay")
    replay_golden(report)

    # phases 5-6
    log("[5] beam path (bench.py shapes, fast configuration)")
    beam_launches = run_main_path(report)

    # phase 7
    log("[7] golden pipeline replay")
    replay_golden_pipeline(report)

    # phase 8
    log("[8] eval pipeline at full width (run_stream, run_batch)")
    launches = run_pipeline(report, main_captioner())
    report["beam_path_launches"] = beam_launches

    rows = []
    for name, src, replaces in (
            ("fused_attention", "vsrcic_tpu_torch/csrc/fused_attention.cu",
             "vsrcic_tpu/ops/fused_attention.py:35"),
            ("vocab_topk", "vsrcic_tpu_torch/csrc/vocab_topk.cu",
             "vsrcic_tpu/ops/vocab_topk.py:47"),
            ("sinkhorn", "vsrcic_tpu_torch/csrc/sinkhorn.cu",
             "scripts/ab_sinkhorn.py:28")):
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"],
                     "max_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    report["kernels"] = kernels
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
