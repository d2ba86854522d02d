"""Time the vocab top-k kernels of two or more checkouts in turns on one
card.

    python3 vsrcic_tpu_torch/tools/ab_vocab.py OLD_DIR NEW_DIR [MORE_DIR ...]
        [--rounds 2] [--beam]
    python3 vsrcic_tpu_torch/tools/ab_vocab.py --sweep

The vocab op at the beam's shape (rows 5120, R 1000, V 10000, k 5;
`chip_smoke.py`'s ROWS, RNN, VOCAB, BEAM) on every operand pair, as each
checkout routes it: "f32" (f32 h2, bf16 table, as the beam calls it on
bf16 tables), "bf16" (bf16 h2 and table, `VSRCIC_VOCAB_LHS_BF16=1`) and
"bf16_k1" (the same at k 1), "f32_table" (f32 h2 and table),
"bf16_h2_f32_table" and "ragged_v" (f32 h2 on a bf16 table at V 9999).
A checkout with `padded_table` gets its tables as the captioner facade
makes them (padded to a pitch of V rounded up to 8, an f32 table's planes
made once); an older one gets them contiguous, as its facade did.
Inputs and timing are `chip_smoke.py`'s, loaded from this checkout: each
time is the device ms per call over 100 launches enqueued while a spin
kernel holds the stream (`held_ms`), beside each stage's device time under
the profiler (`kernel_split`), and every call's result is first held to
the plain version (values and lse within rtol 1e-5 / atol 1e-6, ids equal
save near ties; the worst relative error is recorded). `--beam` times the
beam instead (`chip_smoke.timed_batches`: one warm-up and three batches of
phase 5's inputs), on bf16 and on f32 tables, in captions/s.

Each measurement runs in a subprocess whose `sys.path` starts with one
checkout, so it builds and loads that checkout's kernels (into its own
`vsrcic_tpu_torch/build/`). With two the order is old, new, new, old,
repeated `--rounds` times; with more, each round runs them in order and
then in reverse. `--sweep` times this checkout's kernels at the
beam's shape under other plans beside the ones the wrapper picks: the bf16
route's TMA plans at SWEEP_STAGES ring slots and the split routes' at
SPLIT_SWEEP_STAGES ("split9": two, all that fit), each also split by the
profiler into its stages and
held to the plain version on randn inputs too (logits ~30, where the
tensor cores' truncating sums drift the most); its launches go through
the private `_launch`, which the wrapper's counts do not see.
Every measurement prints one JSON line; all of them go to
`chiprun_out/ab_vocab.json` (the sweep's to `ab_vocab_sweep.json`) beside
the card's name and power limit.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
# (name, h2 dtype, table dtype, V, k): the timed calls
CALLS = (("f32", "float32", "bfloat16", 10000, 5),
         ("bf16", "bfloat16", "bfloat16", 10000, 5),
         ("bf16_k1", "bfloat16", "bfloat16", 10000, 1),
         ("f32_table", "float32", "float32", 10000, 5),
         ("bf16_h2_f32_table", "bfloat16", "float32", 10000, 5),
         ("ragged_v", "float32", "bfloat16", 9999, 5))
BEAM_CALLS = ("beam_bf16_tables", "beam_f32_tables")
SWEEP_STAGES = (2, 3, 4)
SPLIT_SWEEP_STAGES = (2, 3)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables(vt, w, dtype):
    """(table, planes) as the checkout's facade makes them."""
    import torch
    if not hasattr(vt, "padded_table"):
        return w.to(dtype).contiguous(), None
    wt = vt.padded_table(w, dtype)
    return wt, vt.table_planes(wt) if dtype == torch.float32 else None


def _held(smoke, lhs, wt, b, k, call):
    """call() against the plain version (values and lse within rtol 1e-5
    / atol 1e-6, ids equal save near ties), then its held-stream time."""
    import torch
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    got = call()
    torch.cuda.synchronize()
    want = vt.vocab_topk_lse_plain(lhs, wt, b, k)
    pairs = ((got[0], want[0]), (got[2], want[2]))
    ok = all(torch.allclose(g, w, rtol=1e-5, atol=1e-6) for g, w in pairs)
    rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
              for g, w in pairs)
    try:
        near = smoke.vocab_near_ties(lhs, wt, b, got, want)
    except AssertionError:
        ok, near = False, -1
    return {"held_ms": smoke.held_ms(call)[0], "ok": ok,
            "near_tie_rows": near, "max_rel_err": rel}


def _randn_err(plan, dtype, table, k, rows=512, r=1000, v=10000):
    """The worst relative error of `plan` against the plain version on
    phase 3's fourth tie case's kind of input (randn h2, weights and bias:
    logits ~30), where the tensor cores' f32 sums, which truncate at the
    accumulator's scale, drift the most."""
    import torch
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    gen = torch.Generator(device="cuda").manual_seed(2)
    h2 = torch.randn((rows, r), generator=gen, device="cuda").to(dtype)
    wt, planes = _tables(vt, torch.randn((r, v), generator=gen,
                                         device="cuda"), table)
    b = torch.randn((v,), generator=gen, device="cuda")
    if plan.route != "mma_sync":
        plan = vt._tma_plan(plan.route, rows, v, plan.grid, plan.stages,
                            None, plan.planes, plan.w_planes)
    got = vt._launch(plan, h2, wt, b, k, planes)
    want = vt.vocab_topk_lse_plain(h2, wt, b, k)
    return max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
               for g, w in ((got[0], want[0]), (got[2], want[2])))


def _beam(smoke):
    """Phase 5's beam (chip_smoke.timed_batches) with the kernels on bf16
    and on f32 tables: {call: captions/s, seconds, launches}."""
    out = {}
    inputs = smoke.main_inputs()
    for name in BEAM_CALLS:
        cap = smoke.main_captioner(bf16=name == "beam_bf16_tables")
        _, dt, launches = smoke.timed_batches(cap, inputs, 3)
        out[name] = {"captions_per_s": 3 * smoke.BATCH / dt,
                     "seconds": dt, "launches": launches, "ok": True}
        del cap
    return out


def child(repo, sweep, beam=False):
    sys.path.insert(0, repo)
    smoke = _smoke()
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    _build.library()
    out = {"repo": repo}
    if beam:
        out.update(_beam(smoke))
        print(json.dumps(out), flush=True)
        return
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, r, v = smoke.ROWS, smoke.RNN, smoke.VOCAB
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device="cuda"))
    w = (torch.randn((r, v), generator=gen, device="cuda")
         * (2.0 / (r + v)) ** 0.5)
    b = 0.01 * torch.randn((v,), generator=gen, device="cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    if not sweep:
        for name, dtype, table, vv, k in CALLS:
            lhs = h2.to(getattr(torch, dtype))
            wt, planes = _tables(vt, w[:, :vv], getattr(torch, table))
            bb = b[:vv].contiguous()
            kw = {} if planes is None else {"w_planes": planes}
            out[name] = _held(smoke, lhs, wt, bb, k,
                              lambda: vt.vocab_topk_lse(lhs, wt, bb, k, **kw))
            out[name]["split_ms"] = smoke.kernel_split(
                lambda: vt.vocab_topk_lse(lhs, wt, bb, k, **kw), "vocab")
        print(json.dumps(out), flush=True)
        return
    k, dev = smoke.BEAM, h2.device
    sms = _build.sm_count(dev)
    runs = []   # (h2, table dtype, picked plan, other plans)
    picked = vt.vocab_launch_plan(rows, r, v, k, bf16, bf16, True, sms,
                                  vt.resident_clusters(dev, vt.TMA_STAGES))
    runs.append((h2.to(bf16), bf16, picked, [
        vt._plan(rows, r, v, k, True, sms, stages=st,
                 resident=vt.resident_clusters(dev, st))
        for st in SWEEP_STAGES]))
    for lhs, table, route, depths in (
            (h2, bf16, "split", SPLIT_SWEEP_STAGES),
            (h2, f32, "split9", (vt.SPLIT9_STAGES,)),
            (h2.to(bf16), f32, "split_w", SPLIT_SWEEP_STAGES)):
        planes = vt.PLANES[route]
        picked = vt.vocab_launch_plan(
            rows, r, v, k, lhs.dtype, table, True, sms, vt.resident_clusters(
                dev, vt._split_plan(rows, r, v, k, True, sms,
                                    route=route).stages, *planes))
        runs.append((lhs, table, picked, [
            vt._split_plan(rows, r, v, k, True, sms, stages=st,
                           resident=vt.resident_clusters(dev, st, *planes),
                           route=route)
            for st in depths]))
    recs = []
    for lhs, table, picked, others in runs:
        wt, wp = _tables(vt, w, table)
        for plan in dict.fromkeys([picked] + others):
            def call():
                return vt._launch(plan, lhs, wt, b, k, wp)
            rec = _held(smoke, lhs, wt, b, k, call)
            rec["max_rel_err_randn"] = _randn_err(plan, lhs.dtype, table, k)
            rec.update(route=plan.route, cluster=plan.cluster,
                       stages=plan.stages, grid=plan.grid,
                       picked=plan == picked,
                       split_ms=smoke.kernel_split(call, "vocab"))
            recs.append(rec)
            print("  sweep %s, cluster %d, %d stages, grid %d: %.4f ms "
                  "(worst error %.3g relative; randn %.3g) %s%s%s"
                  % (plan.route, plan.cluster, plan.stages, plan.grid,
                     rec["held_ms"], rec["max_rel_err"],
                     rec["max_rel_err_randn"],
                     smoke.fmt_split(rec["split_ms"]),
                     " [plan]" if rec["picked"] else "",
                     "" if rec["ok"] else " MISMATCH"), file=sys.stderr)
    out["plans"] = recs
    print(json.dumps(out), flush=True)


def smoke_split(rec):
    return ", ".join("%s %.4f" % kv for kv in sorted(
        rec.get("split_ms", {}).items()))


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_child(repo, sweep=False, beam=False):
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", repo]
        + (["--sweep"] if sweep else []) + (["--beam"] if beam else []),
        capture_output=True, text=True)
    sys.stderr.write(res.stderr)
    if res.returncode:
        sys.stderr.write(res.stdout)
        raise SystemExit("ab_vocab: the run of %s failed" % repo)
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        return child(os.path.abspath(args[1]), "--sweep" in args,
                     "--beam" in args)
    if args == ["--sweep"]:
        name = card()
        print(name, flush=True)
        rec = run_child(REPO, sweep=True)
        print(json.dumps(rec), flush=True)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "ab_vocab_sweep.json"),
                  "w") as f:
            json.dump({"card": name, "sweep": rec}, f, indent=1)
        if not all(p["ok"] for p in rec["plans"]):
            raise SystemExit("ab_vocab: a plan disagrees with the plain "
                             "version")
        return
    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    beam = "--beam" in args
    if beam:
        args.remove("--beam")
    calls = BEAM_CALLS if beam else [c[0] for c in CALLS]
    if len(args) < 2:
        raise SystemExit(__doc__)
    name = card()
    print(name, flush=True)
    repos = [os.path.abspath(p) for p in args]
    names = ["old", "new"] if len(repos) == 2 else [
        os.path.basename(p) for p in repos]
    order = list(zip(names, repos))
    runs = []
    for _ in range(rounds):
        for which, repo in order + order[::-1]:
            rec = run_child(repo, beam=beam)
            rec["which"] = which
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    for call in calls:
        for which in names:
            recs = [r[call] for r in runs if r["which"] == which]
            if beam:
                print("%-18s %-8s captions/s: %s" % (call, which, " ".join(
                    "%.1f" % x["captions_per_s"] for x in recs)), flush=True)
                continue
            print("%-18s %-8s held ms: %s%s; profiler: %s" % (
                call, which, " ".join("%.4f" % x["held_ms"] for x in recs),
                "" if all(x["ok"] for x in recs) else "  MISMATCH",
                " | ".join(smoke_split(x) for x in recs)), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab_vocab.json"), "w") as f:
        json.dump({"card": name, "runs": runs}, f, indent=1)
    if not all(r[c]["ok"] for r in runs for c in calls):
        raise SystemExit("ab_vocab: a kernel disagrees with its plain "
                         "version")


if __name__ == "__main__":
    main()
