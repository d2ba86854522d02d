"""Time the fused attention kernel of two or more checkouts in turns on one
card, or this checkout's launch plans side by side.

    python3 vsrcic_tpu_torch/tools/ab_fused.py OLD_DIR NEW_DIR [MORE_DIR ...]
        [--rounds 2]
    python3 vsrcic_tpu_torch/tools/ab_fused.py --sweep

Inputs, timing and bound are `chip_smoke.py`'s (`fused_inputs`, `held_ms`,
`fused_bound`, loaded from this tool's checkout), at the four shapes of the
kernel's paths that its phase 3 times: the beam (rows 5120, M 24), SCST's
decode (rows 1024, beam 1, L 20, M 20), the eval CLI's first step (rows
2560 as 512 items x beam 5 on one ctrl each, M 20) and the SCST train CLI
(rows 100, beam 1), all at D 2048, A 512 on bf16 tables. Each time is the
device ms per call over 100 launches enqueued while a spin kernel holds the
stream, and every call's result is first held to the plain version at
rtol / atol 1e-5.

With checkouts, each measurement runs in a subprocess whose `sys.path`
starts with one checkout, so it builds and loads that checkout's kernels
(into its own `vsrcic_tpu_torch/build/`). With two the order is old, new,
new, old, repeated `--rounds` times; with more, each round runs them in
order and then in reverse. `--sweep` times this checkout's kernel under
launch plans beside the one `fused_launch_plan` picks, at the four shapes
and at SWEEP_ROWS more SCST-like row counts: clusters of 1, 2 and 4
blocks, batches of 1 and 8 rows and runs of one row and of half, once and
twice the plan's. Launches that the sweep makes go through the kernel's
launch function, which the wrapper's count does not see. Every measurement
prints one JSON line; all of them go to `chiprun_out/ab_fused.json` beside
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
# (name, rows, B, M, L, beam, ctrl_by): chip_smoke.py phase 3's timed shapes
SHAPES = (("beam", 5120, 1024, 24, 10, 5, "row"),
          ("scst", 1024, 1024, 20, 20, 1, "row"),
          ("eval_cli", 2560, 512, 20, 10, 5, "item"),
          ("rows100", 100, 100, 20, 20, 1, "row"))
SWEEP_ROWS = (37, 66, 132, 200, 400)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    import torch
    return all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
               for g, w in zip(got, want))


def _sweep_plans(fa, rows, m, tb, sms):
    auto = fa.fused_launch_plan(rows, m, 2048, 512, tb, True, sms)
    plans = [auto]
    for c in (1, 2, 4):
        for batch in (1, 8):
            base = fa._plan(rows, m, 2048, 512, tb, True, sms,
                            cluster=c, batch=batch)
            for run in sorted({1, max(1, base.rows_per_run // 2),
                               base.rows_per_run,
                               2 * base.rows_per_run}):
                plan = fa._plan(rows, m, 2048, 512, tb, True, sms,
                                cluster=c, batch=batch, run=run)
                if plan not in plans:
                    plans.append(plan)
    return plans


def child(repo, sweep):
    sys.path.insert(0, repo)
    smoke = _smoke()
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops import fused_attention as fa
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = SHAPES + (tuple(("rows%d" % r, r, r, 20, 20, 1, "row")
                             for r in SWEEP_ROWS) if sweep else ())
    out = {"repo": repo}
    for name, rows, b, m, l, beam, ctrl_by in shapes:
        args = smoke.fused_inputs(gen, rows, b, m, smoke.DET, smoke.ATT,
                                  torch.bfloat16, smoke.M_REGIONS, beam, l,
                                  ctrl_by)
        want = fa.fused_group_attention_plain(*args)
        bound = smoke.fused_bound(args)[0]
        if not sweep:
            ok = _close(fa.fused_group_attention(*args), want)
            out[name] = {"held_ms": smoke.held_ms(
                lambda: fa.fused_group_attention(*args))[0],
                "bound_ms": bound, "ok": ok}
            continue
        recs = []
        sms = _build.sm_count(args[2].device)
        for plan in _sweep_plans(fa, rows, m, 2, sms):
            got = (torch.empty_like(want[0]), torch.empty_like(want[1]))

            def call():
                fa._launch(_build.library(), plan, *args, *got)
            call()
            ok = _close(got, want)
            recs.append(dict(cluster=plan.cluster, batch=plan.batch,
                             rows_per_run=plan.rows_per_run,
                             picked=not recs, ok=ok,
                             held_ms=smoke.held_ms(call, iters=50)[0]))
            print("  sweep %-8s C=%d P=%d run=%3d: %.4f ms (bound %.4f)%s%s"
                  % (name, plan.cluster, plan.batch, plan.rows_per_run,
                     recs[-1]["held_ms"], bound,
                     " [plan]" if len(recs) == 1 else "",
                     "" if ok else " MISMATCH"), file=sys.stderr)
        out[name] = {"bound_ms": bound, "plans": recs}
    print(json.dumps(out), flush=True)


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
        raise SystemExit("ab_fused: the run of %s failed" % repo)
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main():
    args = sys.argv[1:]
    if args[0] == "--child":
        return child(os.path.abspath(args[1]), "--sweep" in args)
    name = card()
    print(name, flush=True)
    runs = []
    if args == ["--sweep"]:
        runs.append(run_child(REPO, sweep=True))
        print(json.dumps(runs[-1]), flush=True)
    else:
        rounds = 2
        if "--rounds" in args:
            i = args.index("--rounds")
            rounds = int(args[i + 1])
            del args[i:i + 2]
        repos = [os.path.abspath(p) for p in args]
        names = ["old", "new"] if len(repos) == 2 else [
            os.path.basename(p) for p in repos]
        order = list(zip(names, repos))
        for _ in range(rounds):
            for which, repo in order + order[::-1]:
                rec = run_child(repo)
                rec["which"] = which
                print(json.dumps(rec), flush=True)
                runs.append(rec)
        for shape, *_ in SHAPES:
            for which in names:
                ms = [r[shape]["held_ms"] for r in runs
                      if r["which"] == which]
                ok = all(r[shape]["ok"] for r in runs
                         if r["which"] == which)
                print("%-8s %-8s held ms: %s%s" % (
                    shape, which, " ".join("%.4f" % x for x in ms),
                    "" if ok else "  MISMATCH"), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab_fused.json"), "w") as f:
        json.dump({"card": name, "runs": runs}, f, indent=1)
    if not all(r[s]["ok"] for r in runs for s, *_ in SHAPES
               if "ok" in r[s]) or not all(
                   p["ok"] for r in runs for s in r
                   if isinstance(r[s], dict) for p in r[s].get("plans", ())):
        raise SystemExit("ab_fused: a kernel disagrees with its plain "
                         "version")


if __name__ == "__main__":
    main()
