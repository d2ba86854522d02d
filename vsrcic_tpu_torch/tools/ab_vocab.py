"""Time the vocab top-k kernels of two or more checkouts in turns on one
card.

    python3 vsrcic_tpu_torch/tools/ab_vocab.py OLD_DIR NEW_DIR [MORE_DIR ...]
        [--rounds 2]
    python3 vsrcic_tpu_torch/tools/ab_vocab.py --sweep

Both entry points of `csrc/vocab_topk.cu` at the beam's shape (rows 5120,
R 1000, V 10000, k 5; `chip_smoke.py`'s ROWS, RNN, VOCAB, BEAM): the f32
one (f32 h2, bf16 table, as the beam calls it on bf16 tables: the split
route since it has one, PR 1's SGEMM before) and the bf16-operand one
(bf16 h2 and table, `VSRCIC_VOCAB_LHS_BF16=1`), plus the bf16 one at k 1.
Inputs and timing are `chip_smoke.py`'s, loaded from each checkout: each
time is the device ms per call over 100 launches enqueued while a spin
kernel holds the stream (`held_ms`), beside each stage's device time under
the profiler (`kernel_split`), and every call's result is first held to
the plain version (values and lse within rtol 1e-5 / atol 1e-6, ids equal
save near ties; the worst relative error is recorded).

Each measurement runs in a subprocess whose `sys.path` starts with one
checkout, so it builds and loads that checkout's kernels (into its own
`vsrcic_tpu_torch/build/`). With two the order is old, new, new, old,
repeated `--rounds` times; with more, each round runs them in order and
then in reverse. `--sweep` times this checkout's kernels at the
beam's shape under other plans beside the ones the wrapper picks: the bf16
route's TMA plans at SWEEP_STAGES ring slots and the split route's at
SPLIT_SWEEP_STAGES, each also split by the profiler into its stages and
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
# (name, h2 dtype, k): the timed calls
CALLS = (("f32", "float32", 5), ("bf16", "bfloat16", 5),
         ("bf16_k1", "bfloat16", 1))
SWEEP_STAGES = (2, 3, 4)
SPLIT_SWEEP_STAGES = (2, 3)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _randn_err(plan, dtype, k, rows=512, r=1000, v=10000):
    """The worst relative error of `plan` against the plain version on
    phase 3's fourth tie case's kind of input (randn h2, weights and bias:
    logits ~30), where the tensor cores' f32 sums, which truncate at the
    accumulator's scale, drift the most."""
    import torch
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    gen = torch.Generator(device="cuda").manual_seed(2)
    h2 = torch.randn((rows, r), generator=gen, device="cuda").to(dtype)
    wt = torch.randn((r, v), generator=gen,
                     device="cuda").to(torch.bfloat16)
    b = torch.randn((v,), generator=gen, device="cuda")
    if plan.route != "mma_sync":
        plan = vt._tma_plan(plan.route, rows, v, plan.grid, plan.stages,
                            None, plan.planes)
    got = vt._launch(plan, h2, wt, b, k)
    want = vt.vocab_topk_lse_plain(h2, wt, b, k)
    return max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
               for g, w in ((got[0], want[0]), (got[2], want[2])))


def child(repo, sweep):
    sys.path.insert(0, repo)
    smoke = _smoke()
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, r, v = smoke.ROWS, smoke.RNN, smoke.VOCAB
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device="cuda"))
    wt = (torch.randn((r, v), generator=gen, device="cuda")
          * (2.0 / (r + v)) ** 0.5).to(torch.bfloat16)
    b = 0.01 * torch.randn((v,), generator=gen, device="cuda")
    out = {"repo": repo}
    if not sweep:
        for name, dtype, k in CALLS:
            lhs = h2.to(getattr(torch, dtype))
            out[name] = _held(smoke, lhs, wt, b, k,
                              lambda: vt.vocab_topk_lse(lhs, wt, b, k))
            out[name]["split_ms"] = smoke.kernel_split(
                lambda: vt.vocab_topk_lse(lhs, wt, b, k), "vocab")
        print(json.dumps(out), flush=True)
        return
    k, dev = smoke.BEAM, h2.device
    sms = _build.sm_count(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    runs = []   # (h2, picked plan, other plans)
    picked = vt.vocab_launch_plan(rows, r, v, k, bf16, bf16, True, sms,
                                  vt.resident_clusters(dev, vt.TMA_STAGES))
    runs.append((h2.to(bf16), picked, [
        vt._plan(rows, r, v, k, True, sms, stages=st,
                 resident=vt.resident_clusters(dev, st))
        for st in SWEEP_STAGES]))
    picked = vt.vocab_launch_plan(rows, r, v, k, f32, bf16, True, sms,
                                  vt.resident_clusters(
                                      dev, vt.SPLIT_STAGES, vt.SPLIT_PLANES))
    runs.append((h2, picked, [
        vt._split_plan(rows, r, v, k, True, sms, stages=st,
                       resident=vt.resident_clusters(dev, st,
                                                     vt.SPLIT_PLANES))
        for st in SPLIT_SWEEP_STAGES]))
    recs = []
    for lhs, picked, others in runs:
        for plan in dict.fromkeys([picked] + others):
            def call():
                return vt._launch(plan, lhs, wt, b, k)
            rec = _held(smoke, lhs, wt, b, k, call)
            rec["max_rel_err_randn"] = _randn_err(plan, lhs.dtype, k)
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


def run_child(repo, sweep=False):
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", repo]
        + (["--sweep"] if sweep else []), capture_output=True, text=True)
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
        return child(os.path.abspath(args[1]), "--sweep" in args)
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
            rec = run_child(repo)
            rec["which"] = which
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    for call, *_ in CALLS:
        for which in names:
            recs = [r[call] for r in runs if r["which"] == which]
            print("%-8s %-8s held ms: %s%s; profiler: %s" % (
                call, which, " ".join("%.4f" % x["held_ms"] for x in recs),
                "" if all(x["ok"] for x in recs) else "  MISMATCH",
                " | ".join(smoke_split(x) for x in recs)), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab_vocab.json"), "w") as f:
        json.dump({"card": name, "runs": runs}, f, indent=1)
    if not all(r[c]["ok"] for r in runs for c, *_ in CALLS):
        raise SystemExit("ab_vocab: a kernel disagrees with its plain "
                         "version")


if __name__ == "__main__":
    main()
