#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vsrcic_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the TF32 settings
     (both off: the JAX reference runs its f32 products at 'highest');
  2. build the kernels from vsrcic_tpu_torch/csrc/ and report the build time;
  3. hold each kernel against its plain PyTorch version on the card: at the
     full-width step shapes, at ragged shapes and on the vocab tie cases;
     time the kernel, its plain version and, for the vocab head, the
     library calls computing the same function;
  4. replay the golden fixture (JAX results) through the kernel path;
  5. drive the main path, `ControllableCaptioner.beam_search_v` at the
     bench.py shapes (batch 1024, beam 5, fused attention, vocab top-k, bf16
     tables): one warm-up and three timed batches, with every kernel's launch
     count reset just before and read just after;
  6. run the same batch through the plain versions on the card and compare.

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
        got = kern(*args)
        torch.cuda.synchronize()
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
    check_fused(gen, kernels)
    check_vocab(gen, kernels)

    # phase 4
    log("[4] golden replay")
    replay_golden(report)

    # phases 5-6
    log("[5] main path (bench.py shapes, fast configuration)")
    launches = run_main_path(report)

    rows = []
    for name, src, replaces in (
            ("fused_attention", "vsrcic_tpu_torch/csrc/fused_attention.cu",
             "vsrcic_tpu/ops/fused_attention.py:35"),
            ("vocab_topk", "vsrcic_tpu_torch/csrc/vocab_topk.cu",
             "vsrcic_tpu/ops/vocab_topk.py:47")):
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
