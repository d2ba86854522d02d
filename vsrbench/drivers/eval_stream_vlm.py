"""The eval stream with Kimi-VL-A3B's language model as the caption
decoder: one caller drives `EvalPipeline.run_stream` (one batch ahead) on
an endless stream of batches cycled from a pool made in set-up, the plan as
`eval_stream`'s and the beam through `KimiVLCaptioner.beam_search_v`.

Traffic parameters: `eval_stream`'s (jobs, pool, the job mix, detections
and regions, warm-up, the traced slice), and for the check:
`check_batches` batches drawn from the seed; in each, one block of
`judge_block` jobs and one step, drawn from the seed: the reference
teacher-forces the block's served beams, and the beams live at that step,
along the program's expert choices.

End-to-end: `captions_per_s`, `batch_p95_ms` (as `eval_stream`'s),
`setup_s`. The checks (`limits/<cell>.json`): the plan's (`planner_gap`,
`sinkhorn_gap`, `plan_exact`, as `eval_stream`'s), `route_gap`,
`logit_gap`, `beam_gap` (the reference's `judge_beams`), `cut_gap` (its
`judge_cut`), `yield_exact`.
"""
from __future__ import annotations

import bisect
import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np

from vsrbench import harness, weights
from vsrbench import yardstick as ys
from vsrbench import yardstick_vlm as yv
from vsrbench.drivers import eval_stream as es
from vsrbench.harness import UNIT_SPAN

SPANS = ("vlm.attn", "vlm.moe")


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def make_kimi(cfg, gen, device):
    """The decoder's weights from `gen`: normal (0, std) matrices, unit
    norms, zero biases, stored in the `weights` group's dtype; the
    router's correction bias normal (0, router_bias_std) in f32. One draw
    a leaf, in the order of `kimi_vl.param_shapes`. Drawn here, as
    `weights.py` draws the other models', so that no initialiser of the
    program sets the benchmark's inputs."""
    import torch
    from vsrcic_tpu_torch.models.kimi_vl import (KimiVLConfig, nest,
                                                 param_shapes)
    kc = KimiVLConfig.from_dict(yv.model(cfg))
    std = cfg["weights"]["std"]
    dtype = getattr(torch, cfg["weights"]["dtype"])
    flat = {}
    for name, shape in param_shapes(kc).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_norm", "kv_norm", "mlp_norm", "norm"):
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf == "bias":
            flat[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif leaf == "router_bias":
            flat[name] = torch.randn(shape, generator=gen, device=device
                                     ) * cfg["weights"]["router_bias_std"]
        else:
            flat[name] = (torch.randn(shape, generator=gen, device=device)
                          .mul_(std).to(dtype))
    return kc, nest(flat, kc.num_hidden_layers)


def make_weights(cfg, seed, device):
    plan = cfg["plan"]
    gen = harness.torch_gen(seed, device, 1)
    w = {"planner": weights.make(weights.planner_leaves(
        cfg["planner"], plan["n_verbs"]), gen, device),
        "sinkhorn": weights.make(weights.sinkhorn_leaves(cfg["sinkhorn"]),
                                 gen, device)}
    w["kimi_cfg"], w["kimi"] = make_kimi(cfg, harness.torch_gen(
        seed, device, 3), device)
    w["tense_map"], w["tense_ids"] = weights.tense_table(
        plan["n_verbs"], cfg["vocab_size"], plan["tenses"],
        harness.numpy_rng(seed, 2))
    return w


def build_program(cfg, w, device):
    """The pipeline with the decoder's facade, on the weights themselves
    (the facade only reads them) and copies of the plan's."""
    from vsrcic_tpu_torch.models.kimi_vl import KimiVLCaptioner
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.pipelines.eval_pipeline import EvalPipeline
    prog, plan = cfg["program"], cfg["plan"]
    captioner = KimiVLCaptioner(w["kimi_cfg"], w["kimi"],
                                verb_2_vob_all=w["tense_map"],
                                device=device)
    pl = {k: v for k, v in cfg["planner"].items()
          if k in SSPConfig.__dataclass_fields__}
    return EvalPipeline(
        captioner, weights.clone(w["planner"]), SSPConfig(**pl),
        weights.clone(w["sinkhorn"]), SinkhornConfig(**cfg["sinkhorn"]),
        eos_word=plan["eos_word"], fixed_len=plan["fixed_len"],
        sinkhorn_len=cfg["sinkhorn"]["n"], beam_size=prog["beam_size"],
        gt=False, fast_ssp=prog["fast_ssp"], device=device)


def counters_of(captioner):
    def counters():
        from vsrcic_tpu_torch.ops import vocab_topk
        out = {"vocab": vocab_topk.vocab_topk_lse.launches}
        out.update(captioner.device_counts())
        return out
    return counters


class SpanTracer(harness.Tracer):
    """The harness's tracer, also keeping the device time (ms) of the
    operations that each of `SPANS` launched: each device operation is
    joined to the host call that launched it (a kernel launch, or the
    launch of a CUDA graph whose kernels it ran) by the profiler's
    correlation id, and given to the span open on the host at that
    launch."""

    def _reduce(self, prof):
        super()._reduce(prof)
        from torch.autograd import DeviceType
        self.span_ms = dict.fromkeys(SPANS, 0.0)
        self.span_count = dict.fromkeys(SPANS, 0)
        ranges, launches, device = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                device.append((e.correlation_id(), e.duration_ns()))
            elif name in self.span_ms:
                ranges.append((e.start_ns(), e.end_ns(), name))
                self.span_count[name] += 1
            elif name.startswith("cuda") and "Launch" in name:
                launches[e.correlation_id()] = e.start_ns()
        ranges.sort()
        starts = [r[0] for r in ranges]
        self.joined = 0
        for corr, dur in device:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][1] >= t:
                self.span_ms[ranges[i][2]] += dur / 1e6
                self.joined += 1


def pool_stats(cfg, tr, pool):
    """Per pool batch: the jobs' real detections (host list) and the
    batch's model operations (`yardstick_vlm`, the plan's by
    `yardstick`)."""
    c = yv.model(cfg)
    shape = es.shape_of(cfg, tr)
    plan = (ys.ssp_flops(cfg["planner"], shape["groups"],
                         shape["planner_tokens"], shape["planner_steps"])
            + ys.sinkhorn_flops(cfg["sinkhorn"], shape["groups"],
                                shape["pairs"]))
    out = []
    for b in pool:
        n_real = (b.dets.sum(-1) != 0).sum(1).tolist()
        flops = (yv.prefill_flops(c, n_real)
                 + yv.decode_flops(c, n_real, shape["beam"])
                 + yv.control_flops(c, tr["jobs"], cfg["plan"]["fixed_len"],
                                    cfg["plan"]["regions"]) + plan)
        out.append(SimpleNamespace(n_real=n_real, flops=flops))
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(cell, args, device, t_process):
    import torch
    cfg, tr = cell.config, cell.traffic
    trace = bool(args.trace)
    stages = [("start", t_process), ("imports", time.perf_counter())]
    w = make_weights(cfg, args.seed, device)
    stages.append(("weights", time.perf_counter()))
    pipe = build_program(cfg, w, device)
    stages.append(("program", time.perf_counter()))
    pool = [es.make_batch(cfg, tr, args.seed, i, device)
            for i in range(tr["pool"])]
    stats = pool_stats(cfg, tr, pool)
    stages.append(("inputs", time.perf_counter()))
    rf = None
    if trace:
        from torch.profiler import record_function as rf
    spans = harness.Spans(rf)
    captured = {"gen": [], "sink": [], "plan": [], "beam": []}
    es.instrument(pipe, spans, captured)

    for _ in pipe.run_stream([b.stream for b in
                              pool[:tr["warmup_batches"]]]):
        pass
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    stages.append(("warm-up", time.perf_counter()))
    for v in captured.values():
        v.clear()
    spans.items.clear()

    draws, yields = [], []
    stop = [False]

    def feed():
        i = 0
        while not stop[0]:
            draws.append(time.perf_counter())
            yield pool[i % len(pool)].stream
            i += 1

    stream = pipe.run_stream(feed())
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while True:
        with spans.span(UNIT_SPAN):
            words = next(stream)
        yields.append((time.perf_counter(), words))
        if yields[-1][0] >= deadline:
            break
    t_end = yields[-1][0]
    from vsrcic_tpu_torch.utils import observability as obs
    print("vsrbench: " + obs.summary_line(obs.summary(t0_ns), len(yields),
                                          "batch"), file=sys.stderr)
    tracer = None
    if trace:
        tracer = SpanTracer(device, tr["trace_wait"], tr["trace_units"])
        tracer.start()
        while not tracer.done:
            with spans.span(UNIT_SPAN):
                next(stream)
            tracer.step(counters_of(pipe.captioner))
        tracer.stop()
    stop[0] = True
    stream.close()
    sync()
    card = harness.card_info(device)
    setup_s = t0 - t_process
    window_s = t_end - t0
    n = len(yields)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    result = {"attempted": n * tr["jobs"], "failed": 0,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": card["kind"],
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if not trace:
        values = {"captions_per_s": n * tr["jobs"] / window_s,
                  "batch_p95_ms": es.p95_ms([y[0] - d for y, d in
                                             zip(yields, draws)]),
                  "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": values[k], "unit": units[k]}
                             for k in units}
        lat = sorted(1e3 * (y[0] - d) for y, d in zip(yields, draws))
        print("vsrbench: %d batches of %d jobs in %.3f s; batch latency ms "
              "(%d samples): p50 %.1f, p90 %.1f, p95 %.1f, max %.1f"
              % (n, tr["jobs"], window_s, n, lat[n // 2],
                 lat[math.ceil(0.9 * n) - 1], values["batch_p95_ms"],
                 lat[-1]), file=sys.stderr)
    else:
        sl = harness.Slice(tracer, es.PLAN_SPANS + es.BEAM_SPANS
                           + (UNIT_SPAN,))
        ctx = SimpleNamespace(config=cfg, traffic=tr, slice=sl, spans=spans,
                              window=(t0, t_end), window_s=window_s,
                              units=n, shape=es.shape_of(cfg, tr), card=card,
                              pool=stats, span_ms=tracer.span_ms)
        result["metrics"] = harness.read_metrics(cell, ctx)
        result["device"].update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["breakdown"] = sl.breakdown()
        print("vsrbench: traced slice of %d batches: device ms by span %s "
              "(ranges %s, device operations joined to a launch %s); counts "
              "%s" % (sl.units, tracer.span_ms, tracer.span_count,
                      getattr(tracer, "joined", None), sl.counters),
              file=sys.stderr)
    result["card"] = {"name": card["kind"],
                      "power_limit_w": card["power_limit_w"]}
    print("vsrbench: card %s, power limit %s W; setup_s %.3f (%s)"
          % (card["kind"], card["power_limit_w"], setup_s,
             harness.stage_line(stages)), file=sys.stderr)

    outputs = es.collect(captured, yields)
    del pipe, stream, captured
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge(cfg, tr, w, pool, outputs, args.seed, cell.limits)
    result["failed"] = failed
    result["correct"] = all(c["value"] <= c["limit"] for c in
                            checks.values())
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "card")
    return {k: result[k] for k in order if k in result}, checks


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

NUMBERS = ("planner_gap", "sinkhorn_gap", "plan_exact", "route_gap",
           "logit_gap", "beam_gap", "cut_gap")
SERVED = ("words", "gates", "word_logps", "gate_logps", "scores", "head",
          "head_ids", "routes")
STEPS = ("parents", "step_words", "step_gates", "step_routes")


def judge(cfg, tr, w, pool, outputs, seed, limits, control=None):
    """Every yielded batch's words against its facade result's best beam;
    then `check_batches` batches drawn from the seed, judged by the
    reference. Returns ({name: {"value", "limit"}}, jobs failed)."""
    yield_bad = 0
    for o in outputs:
        best = o["beam"].words[:, 0].cpu().numpy()
        yield_bad += int((np.asarray(o["words"]) != best).any(1).sum())
    rng = harness.numpy_rng(seed, 30)
    pick = rng.choice(len(outputs), min(tr["check_batches"], len(outputs)),
                      replace=False)
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = yield_bad
    for i in sorted(pick):
        at = int(rng.integers(tr["jobs"] // tr["judge_block"])
                 ) * tr["judge_block"]
        step = int(rng.integers(1, yv.model(cfg)["seq_len"]))
        got = judge_batch(cfg, tr, w, pool[i % len(pool)], outputs[i],
                          limits, at, step, control)
        for k in worst:
            worst[k] = max(worst[k], got[k])
        failed += got["failed"]
    values = dict(worst, yield_exact=yield_bad)
    return ({k: {"value": float(v), "limit": limits[k]}
             for k, v in values.items()}, int(failed))


def judge_plan(cfg, w, batch, out):
    """The plan's checks, as `eval_stream.judge_batch` takes them: (planner
    gap, Sinkhorn gap, plan_exact, jobs whose plan differs (P,) bool,
    rank_idx, rank_valid, verb_lists, inputs the same)."""
    import torch
    from vsrbench.reference import plan as rp
    from vsrbench.reference import planner as rpl
    plan = cfg["plan"]
    n = cfg["sinkhorn"]["n"]
    cv, dv, dsr, vl = batch.fields
    dev = batch.dets.device
    n_jobs, length = dsr.shape[0], plan["fixed_len"]
    groups = [rp.verb_groups(cv[p], dv[p], dsr[p], plan["max_sr"])
              for p in range(n_jobs)]
    verbs = np.asarray([g[0] for gs in groups for g in gs])
    det_sr = np.stack([g[1] for gs in groups for g in gs])
    g_verbs, g_det_sr, preds, lps = out["gen"]
    same_in = (np.array_equal(verbs, g_verbs.reshape(-1).cpu().numpy())
               and np.array_equal(det_sr, g_det_sr.cpu().numpy()))
    pj = rpl.judge_planner(w["planner"], cfg["planner"],
                           torch.from_numpy(verbs).to(dev),
                           torch.from_numpy(det_sr).to(dev), preds, lps)
    planner_gap = float(torch.maximum(pj["selection"], pj["record"]).max())
    owner, locs, valid = rp.sinkhorn_rows(groups, n)
    sink_gap = 0.0
    soft = np.zeros((0, n, n), np.float32)
    if out["sink"] is not None:
        s_owner, s_locs, s_valid, p_got = out["sink"]
        same_in = same_in and all(
            np.array_equal(a, b.cpu().numpy())
            for a, b in ((owner, s_owner), (locs, s_locs), (valid, s_valid)))
        feats = torch.cat(list(batch.feats), -1)
        rows = feats[torch.from_numpy(owner).to(dev)[:, None],
                     torch.from_numpy(locs).to(dev)]
        rows = rows * torch.from_numpy(valid).to(dev)[..., None]
        soft = p_got.float().cpu().numpy()
        p_ref = rpl.sinkhorn_net(w["sinkhorn"], cfg["sinkhorn"], rows)
        sink_gap = float((p_got.float() - p_ref).abs().max())
    elif len(owner):
        same_in = False
    rank_idx, rank_valid, verb_lists = rp.compose(
        groups, preds.cpu().numpy(), soft, vl[:, :, 0], length, n)
    g_idx, g_valid, g_vl = out["plan"]
    bad = ~((np.asarray(g_idx) == rank_idx).all(1)
            & (np.asarray(g_valid) == rank_valid).all(1)
            & (np.asarray(g_vl) == verb_lists).all(1))
    plan_exact = n_jobs if not same_in else int(bad.sum())
    return (planner_gap, sink_gap, plan_exact, bad, rank_idx, rank_valid,
            verb_lists, same_in)


def judge_batch(cfg, tr, w, batch, out, limits, judge_at, step,
                control=None):
    """The reference's readings of one batch's outputs: the plan's, the
    beams of the `judge_block` jobs from `judge_at`, teacher-forced along
    the program's expert choices (`kimi_vl_lm.judge_beams`), and the
    joint top-K cut of their `step` (`kimi_vl_lm.judge_cut`): the beams
    live at that step, rebuilt from the program's parent pointers and
    teacher-forced likewise, against the beams the step kept.

    No number holds the served beams to a search of the reference's own,
    as `eval_stream`'s `search_gap` does: at the vocabulary's 163840 ids
    the K-th and (K+1)-th child of every job lie within a few thousandths
    of a nat at some step, well inside bf16's rounding, and from there two
    sound searches settle on other beams, 7-15% apart in score on this
    random model (PERF.md section 2), as far as a float8 search lies. The
    cut judges each step's selection from the beams the program had.

    `control` (vsrbench/control_vlm.py): an object with `config` (the
    decoder's configuration with its expert products on float8 inputs).
    Given, the reference at that precision stands in the program's place
    along the served paths, with its own expert choices (its top-k logits,
    lse, gate log-probs, records and scores replace the program's), and
    keeps its own K best children of the step's live beams."""
    import torch
    from vsrbench.reference import kimi_vl_lm as ref
    from vsrbench.reference import plan as rp
    (planner_gap, sink_gap, plan_exact, bad, rank_idx, rank_valid,
     verb_lists, same_in) = judge_plan(cfg, w, batch, out)
    c = yv.model(cfg)
    dev = batch.dets.device
    tense = torch.from_numpy(w["tense_ids"]).to(dev)
    vl_t = torch.from_numpy(verb_lists).long().to(dev)
    res = out["beam"]
    per_job_bad = bad.copy()

    sl = slice(judge_at, judge_at + tr["judge_block"])
    recons = rp.recons(batch.seqs[sl], rank_idx[sl], rank_valid[sl])
    served = {k: getattr(res, k)[sl] for k in SERVED}
    served["prefix_routes"] = res.prefix_routes[sl]
    steps = {k: getattr(res, k)[sl] for k in STEPS}
    steps["prefix_routes"] = served["prefix_routes"]
    args = (batch.dets[sl], recons, vl_t[sl], tense)
    chosen = None
    if control is not None:
        mine = dict(served)
        del mine["routes"]
        served = ref.judge_beams(w["kimi"], control.config, *args, mine,
                                 cfg["plan"]["eos_word"])["paths"]
        del steps["step_routes"], steps["prefix_routes"]
        _, chosen = ref.judge_cut(w["kimi"], control.config, *args, steps,
                                  step)
    jb = ref.judge_beams(w["kimi"], c, *args, served,
                         cfg["plan"]["eos_word"])
    cut, _ = ref.judge_cut(w["kimi"], c, *args, steps, step, chosen)
    gaps = {"route_gap": jb["route"], "logit_gap": jb["logit"],
            "beam_gap": jb["beam"], "cut_gap": cut}
    worst = {k: float(v.max()) for k, v in gaps.items()}
    for k, v in gaps.items():
        per_job_bad[sl] |= (v > limits[k]).cpu().numpy()
    del recons, jb
    return dict(worst, planner_gap=planner_gap, sinkhorn_gap=sink_gap,
                plan_exact=plan_exact,
                failed=int(per_job_bad.sum()) if same_in
                else len(per_job_bad))
