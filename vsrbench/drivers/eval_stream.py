"""The eval stream: one caller drives `EvalPipeline.run_stream` (one batch
ahead, the eval CLI's schedule) on an endless stream of batches of
caption jobs, cycled from a pool made in set-up.

Traffic parameters (`traffic/<name>.json`): `jobs` a batch; `pool`
distinct batches; `verbs_per_job`, a pattern the jobs follow in turn;
per verb one role held by `shared_slots` slots (an ambiguous pair: one
Sinkhorn matrix), `unique_roles` roles of one slot each and one slot of
the role `verb_role` that holds the verb; roles drawn from 1..`roles`,
verbs from 1..n_verbs; `real_detections` [lo, hi] detections of an image
that are not zero, `regions_per_group` [lo, hi] regions of a group that
are not zero; `warmup_batches`; the traced slice, run once the window
has closed (`trace_wait` batches, one of warm-up, then `trace_units`); the
check (`check_batches` batches drawn from the seed, judged in blocks of
`judge_block` jobs, one block of each by the reference's own beam search,
whose near ties, under `search_tie` relative, leave a job out of it).

Every seed gives the same sizes (jobs, groups, pairs, slots, roles a
group); only the values differ.

End-to-end: `captions_per_s` (captions of the batches whose words were
yielded in the window over the window's seconds; the window ends at the
first yield at or past `--seconds`), `batch_p95_ms` (nearest-rank 95th
percentile of those batches' latencies, from the moment run_stream drew
the batch from the generator to the moment its words were yielded),
`setup_s`.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np

from vsrbench import harness, weights
from vsrbench.harness import UNIT_SPAN

PLAN_SPANS = ("plan_dispatch", "plan_finish", "_build_recons")
BEAM_SPANS = ("_dispatch_beam", "_start_readback", "_finish_readback")


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def slots_per_verb(tr):
    return tr["shared_slots"] + tr["unique_roles"] + 1


def make_fields(tr, plan, seed, index):
    """The jobs' host control fields: control_verb (P, 8), det_v and
    det_sr (P, L, 8), verb_list (P, L, 1)."""
    rng = harness.numpy_rng(seed, 10, index)
    n_jobs, length = tr["jobs"], plan["fixed_len"]
    control_verb = np.zeros((n_jobs, 8))
    det_v = np.zeros((n_jobs, length, 8))
    det_sr = np.zeros((n_jobs, length, 8))
    verb_list = np.full((n_jobs, length, 1), -1.0)
    per = slots_per_verb(tr)
    pattern = tr["verbs_per_job"]
    for p in range(n_jobs):
        nv = pattern[p % len(pattern)]
        verbs = 1 + rng.choice(plan["n_verbs"], nv, replace=False)
        for vi, verb in enumerate(verbs):
            roles = 1 + rng.choice(tr["roles"], 1 + tr["unique_roles"],
                                   replace=False)
            lo = vi * per
            control_verb[p, vi] = verb
            det_v[p, lo:lo + per, 0] = verb
            det_sr[p, lo:lo + per, 0] = ([roles[0]] * tr["shared_slots"]
                                         + list(roles[1:])
                                         + [tr["verb_role"]])
            verb_list[p, lo + per - 1, 0] = verb
    return control_verb, det_v, det_sr, verb_list


def make_batch(cfg, tr, seed, index, device):
    """One batch: host fields, the CaptionJobs, and on the device the
    detections, the staged group features (and their f32 row sums) and
    the Sinkhorn features."""
    import torch
    from vsrcic_tpu_torch.pipelines.eval_pipeline import CaptionJob
    c, plan = cfg["captioner"], cfg["plan"]
    cv, dv, dsr, vl = make_fields(tr, plan, seed, index)
    n_jobs, length, m = tr["jobs"], plan["fixed_len"], plan["regions"]
    d, n_det = c["det_feat_size"], plan["detections"]
    g = harness.torch_gen(seed, device, 20, index)

    def between(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (torch.rand(shape, generator=g, device=device)
                     * (hi - lo + 1)).long().clamp_max(hi - lo)

    dets = torch.randn((n_jobs, n_det, d), generator=g, device=device)
    real = between(tr["real_detections"], (n_jobs,))
    dets.mul_((torch.arange(n_det, device=device)[None, :]
               < real[:, None])[..., None])
    used = torch.from_numpy((dv[:, :, 0] != 0).sum(1)).to(device)
    seqs = torch.randn((n_jobs, length, m, d), generator=g, device=device)
    regions = between(tr["regions_per_group"], (n_jobs, length))
    live = ((torch.arange(m, device=device) < regions[..., None])
            & (torch.arange(length, device=device)[None, :, None]
               < used[:, None, None]))
    seqs.mul_(live[..., None])
    sk = cfg["sinkhorn"]
    vis = torch.randn((n_jobs, length, sk["vis_dim"]), generator=g,
                      device=device)
    txt = torch.randn((n_jobs, length, sk["txt_dim"]), generator=g,
                      device=device)
    pos = torch.rand((n_jobs, length, sk["pos_dim"]), generator=g,
                     device=device)
    jobs = [CaptionJob(seqs_vis=None, seqs_txt=None, seqs_pos=None,
                       seqs_all=None, control_verb=cv[p], det_seqs_v=dv[p],
                       det_seqs_sr=dsr[p], verb_list=vl[p])
            for p in range(n_jobs)]
    staged = (seqs, seqs.sum((2, 3)))
    return SimpleNamespace(
        fields=(cv, dv, dsr, vl), jobs=jobs, dets=dets, seqs=seqs,
        feats=(vis, txt, pos), stream=(dets, jobs, staged, (vis, txt, pos)))


def shape_of(cfg, tr):
    """What a batch holds, the same for every seed."""
    pattern = tr["verbs_per_job"]
    groups = sum(pattern[p % len(pattern)] for p in range(tr["jobs"]))
    return {"items": tr["jobs"], "beam": cfg["program"]["beam_size"],
            "groups": groups,
            "pairs": groups if tr["shared_slots"] > 1 else 0,
            "planner_tokens": cfg["plan"]["fixed_len"],
            "planner_steps": 2 + tr["unique_roles"]}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def make_weights(cfg, seed, device):
    c, plan = cfg["captioner"], cfg["plan"]
    gen = harness.torch_gen(seed, device, 1)
    w = {"captioner": weights.make(weights.captioner_leaves(c), gen, device),
         "planner": weights.make(weights.planner_leaves(
             cfg["planner"], plan["n_verbs"]), gen, device),
         "sinkhorn": weights.make(weights.sinkhorn_leaves(cfg["sinkhorn"]),
                                  gen, device)}
    w["tense_map"], tense_ids = weights.tense_table(
        plan["n_verbs"], c["vocab_size"], plan["tenses"],
        harness.numpy_rng(seed, 2))
    w["tense_ids"] = tense_ids
    return w


def build_program(cfg, w, device):
    """The eval CLI's objects, on copies of the weights."""
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.pipelines.eval_pipeline import EvalPipeline
    prog, plan = cfg["program"], cfg["plan"]
    # f32 tables: the eval CLI passes None without --bf16_tables
    tables = {"float32": None, "bfloat16": torch.bfloat16}[prog["table_dtype"]]
    captioner = ControllableCaptioner(
        CaptionerConfig(**cfg["captioner"]),
        params=weights.clone(w["captioner"]), verb_2_vob_all=w["tense_map"],
        use_fused_attention=prog["use_fused_attention"],
        use_vocab_topk=prog["use_vocab_topk"], table_dtype=tables,
        device=device)
    pl = {k: v for k, v in cfg["planner"].items()
          if k in SSPConfig.__dataclass_fields__}
    return EvalPipeline(
        captioner, weights.clone(w["planner"]), SSPConfig(**pl),
        weights.clone(w["sinkhorn"]), SinkhornConfig(**cfg["sinkhorn"]),
        eos_word=plan["eos_word"], fixed_len=plan["fixed_len"],
        sinkhorn_len=cfg["sinkhorn"]["n"], beam_size=prog["beam_size"],
        gt=False, fast_ssp=prog["fast_ssp"], device=device)


def counters():
    from vsrcic_tpu_torch.ops import sinkhorn, vocab_topk
    return {"vocab": vocab_topk.vocab_topk_lse.launches,
            "sinkhorn": sinkhorn.sinkhorn_normalize.launches}


def instrument(pipe, spans, captured):
    """Spans around the pipeline's steps, and the outputs the check needs
    kept as the timed path makes them (device tensors, no wait): the
    planner's tokens and log-probs with their inputs, the Sinkhorn
    matrices with theirs, each batch's plan and each beam's facade
    result."""
    for name in PLAN_SPANS:
        spans.wrap(pipe, name, keep=(captured["plan"].append
                                     if name == "plan_finish" else None))
    for name in BEAM_SPANS:
        spans.wrap(pipe, name)
    gen = pipe._gen

    def gen_kept(params, cfg, verbs, det_sr, **kw):
        out = gen(params, cfg, verbs, det_sr, **kw)
        captured["gen"].append((verbs, det_sr) + tuple(out))
        return out
    pipe._gen = gen_kept
    gather = pipe._sinkhorn_gather

    def gather_kept(vis, txt, pos, owner, locs, valid):
        out = gather(vis, txt, pos, owner, locs, valid)
        captured["sink"].append((owner, locs, valid, out))
        return out
    pipe._sinkhorn_gather = gather_kept
    cap = pipe.captioner
    beam = cap.beam_search_v

    def beam_kept(*a, **kw):
        out = beam(*a, **kw)
        captured["beam"].append(out)
        return out
    cap.beam_search_v = beam_kept


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def p95_ms(latencies):
    xs = sorted(latencies)
    return 1e3 * xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def run(cell, args, device, t_process):
    import torch
    cfg, tr = cell.config, cell.traffic
    trace = bool(args.trace)
    stages = [("start", t_process), ("imports", time.perf_counter())]
    w = make_weights(cfg, args.seed, device)
    stages.append(("weights", time.perf_counter()))
    pipe = build_program(cfg, w, device)
    stages.append(("program", time.perf_counter()))
    pool = [make_batch(cfg, tr, args.seed, i, device)
            for i in range(tr["pool"])]
    stages.append(("inputs", time.perf_counter()))
    rf = None
    if trace:
        from torch.profiler import record_function as rf
    spans = harness.Spans(rf)
    captured = {"gen": [], "sink": [], "plan": [], "beam": []}
    instrument(pipe, spans, captured)

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
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while True:
        with spans.span(UNIT_SPAN):
            words = next(stream)
        yields.append((time.perf_counter(), words))
        if yields[-1][0] >= deadline:
            break
    t_end = yields[-1][0]
    tracer = None
    if trace:
        # the traced slice: further batches of the same stream, once the
        # window has closed
        tracer = harness.Tracer(device, tr["trace_wait"], tr["trace_units"])
        tracer.start()
        while not tracer.done:
            with spans.span(UNIT_SPAN):
                next(stream)
            tracer.step(counters)
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
                  "batch_p95_ms": p95_ms([y[0] - d for y, d in
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
        sl = harness.Slice(tracer, PLAN_SPANS + BEAM_SPANS + (UNIT_SPAN,))
        ctx = SimpleNamespace(config=cfg, traffic=tr, slice=sl, spans=spans,
                              window=(t0, t_end), window_s=window_s,
                              units=n, shape=shape_of(cfg, tr), card=card)
        result["metrics"] = harness.read_metrics(cell, ctx)
        result["device"].update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["breakdown"] = sl.breakdown()
        report_launches(sl, cfg)
    result["card"] = {"name": card["kind"],
                      "power_limit_w": card["power_limit_w"]}
    print("vsrbench: card %s, power limit %s W; setup_s %.3f (%s)"
          % (card["kind"], card["power_limit_w"], setup_s,
             harness.stage_line(stages)), file=sys.stderr)

    outputs = collect(captured, yields)
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


def report_launches(sl, cfg):
    """The profiler's count of vocab head launches in the slice beside the
    wrapper's counter and what the beam makes."""
    steps = sl.units * cfg["captioner"]["seq_len"]
    want = steps if cfg["program"]["use_vocab_topk"] else 0
    _, merges = sl.device_ms(("vocab_merge_kernel",))
    got = (sl.counters or {}).get("vocab")
    line = ("vsrbench: launches in the traced slice of %d batches: vocab "
            "head %s by the counter, %d merge kernels by the profiler, %d "
            "made by the beam" % (sl.units, got, merges, want))
    if (got, merges) != (want, want):
        line += " (they differ)"
    print(line, file=sys.stderr)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def collect(captured, yields):
    """Per yielded batch: the yielded words (host) and the outputs kept
    from its plan and beam (device)."""
    out = []
    for i, (_, words) in enumerate(yields):
        out.append({"words": words, "gen": captured["gen"][i],
                    "sink": (captured["sink"][i] if captured["sink"]
                             else None),
                    "plan": captured["plan"][i], "beam": captured["beam"][i]})
    return out


def judge(cfg, tr, w, pool, outputs, seed, limits):
    """Every yielded batch's words against its facade result's best beam;
    then a sample of the batches, drawn from the seed, judged by the
    reference. Returns ({name: {"value", "limit"}}, jobs failed)."""
    yield_bad = 0
    for o in outputs:
        best = o["beam"].words[:, 0].cpu().numpy()
        yield_bad += int((np.asarray(o["words"]) != best).any(1).sum())
    rng = harness.numpy_rng(seed, 30)
    pick = rng.choice(len(outputs), min(tr["check_batches"], len(outputs)),
                      replace=False)
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed, judged, searched = yield_bad, 0, 0
    for i in sorted(pick):
        got = judge_batch(cfg, tr, w, pool[i % len(pool)], outputs[i],
                          limits, search_at=search_block(tr, rng))
        for k in worst:
            worst[k] = max(worst[k], got[k])
        failed += got["failed"]
        judged += got["search_judged"]
        searched += tr["judge_block"]
    print("vsrbench: the reference's own beam search: %d of %d jobs judged "
          "(the rest meet a near tie at some step)" % (judged, searched),
          file=sys.stderr)
    values = dict(worst, yield_exact=yield_bad)
    return ({k: {"value": float(v), "limit": limits[k]}
             for k, v in values.items()}, int(failed))


NUMBERS = ("planner_gap", "sinkhorn_gap", "plan_exact", "beam_gap",
           "search_gap")


def search_block(tr, rng):
    """The first job of the block that the reference's own beam search
    runs on, drawn from `rng`."""
    return int(rng.integers(tr["jobs"] // tr["judge_block"])
               ) * tr["judge_block"]


def judge_batch(cfg, tr, w, batch, out, limits, control=None, search_at=0):
    """The reference's readings of one batch's outputs.

    Teacher forcing (`judge_beams`) holds each served beam to the
    reference's step along its own path; the reference's own beam search
    over the `judge_block` jobs from `search_at` holds the served beams'
    scores, rank by rank, to the beams it keeps (`search_gap`, relative),
    on the jobs where it meets no near tie (`search_tie`): so a decode
    that keeps other beams than the joint top K, or ranks them otherwise,
    is seen.

    `control` (vsrbench/control.py): an object with the control's weights
    (`weights`) and a context (`precision()`) in which the reference runs
    below the configuration's precision. Given, the reference stands in
    the program's place at the same positions, each of the program's
    numeric outputs replaced by its own there (the planner's log-probs of
    the served roles, the Sinkhorn matrices, the beam's records and scores
    along the served paths), and these are judged instead."""
    import torch
    from vsrbench.reference import captioner as rc
    from vsrbench.reference import plan as rp
    from vsrbench.reference import planner as rpl
    c, plan = cfg["captioner"], cfg["plan"]
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
    v_t = torch.from_numpy(verbs).to(dev)
    sr_t = torch.from_numpy(det_sr).to(dev)
    if control is not None:
        with control.precision():
            lps = rpl.judge_planner(control.weights["planner"],
                                    cfg["planner"], v_t, sr_t, preds,
                                    lps)["served_logps"]
    pj = rpl.judge_planner(w["planner"], cfg["planner"], v_t, sr_t,
                           preds, lps)
    planner_gap = float(torch.maximum(pj["selection"], pj["record"]).max())

    owner, locs, valid = rp.sinkhorn_rows(groups, n)
    sink_gap = 0.0
    soft = np.zeros((0, n, n), np.float32)
    if out["sink"] is not None:
        s_owner, s_locs, s_valid, p_got = out["sink"]
        same_in = same_in and all(
            np.array_equal(a, b.cpu().numpy())
            for a, b in ((owner, s_owner), (locs, s_locs), (valid, s_valid)))
        vis, txt, pos = batch.feats
        feats = torch.cat([vis, txt, pos], -1)
        rows = feats[torch.from_numpy(owner).to(dev)[:, None],
                     torch.from_numpy(locs).to(dev)]
        rows = rows * torch.from_numpy(valid).to(dev)[..., None]
        soft = p_got.float().cpu().numpy()
        if control is not None:
            with control.precision():
                p_got = rpl.sinkhorn_net(control.weights["sinkhorn"],
                                         cfg["sinkhorn"], rows)
        p_ref = rpl.sinkhorn_net(w["sinkhorn"], cfg["sinkhorn"], rows)
        sink_gap = float((p_got.float() - p_ref).abs().max())
    elif len(owner):
        same_in = False

    rank_idx, rank_valid, verb_lists = rp.compose(
        groups, preds.cpu().numpy(), soft, vl[:, :, 0], length, n)
    g_idx, g_valid, g_vl = out["plan"]
    bad_jobs = ~((np.asarray(g_idx) == rank_idx).all(1)
                 & (np.asarray(g_valid) == rank_valid).all(1)
                 & (np.asarray(g_vl) == verb_lists).all(1))
    plan_exact = n_jobs if not same_in else int(bad_jobs.sum())

    res = out["beam"]
    served = {"words": res.words, "gates": res.gates,
              "word_logps": res.word_logps, "gate_logps": res.gate_logps,
              "scores": res.scores}
    tense = torch.from_numpy(w["tense_ids"]).to(dev)
    vl_t = torch.from_numpy(verb_lists).long().to(dev)
    gaps = []
    block = tr["judge_block"]
    for lo in range(0, n_jobs, block):
        sl = slice(lo, lo + block)
        recons = rp.recons(batch.seqs[sl], rank_idx[sl], rank_valid[sl])
        part = {k: v[sl] for k, v in served.items()}
        if control is not None:
            with control.precision():
                part = rc.judge_beams(control.weights["captioner"], c,
                                      batch.dets[sl], recons, vl_t[sl],
                                      tense, part, plan["eos_word"])["paths"]
        jb = rc.judge_beams(w["captioner"], c, batch.dets[sl], recons,
                            vl_t[sl], tense, part, plan["eos_word"])
        gaps.append(torch.stack([jb["selection"], jb["record"],
                                 jb["score"]], 1).amax(1))
        del recons
    beam_gap = torch.cat(gaps)
    per_job_bad = (beam_gap > limits["beam_gap"]).cpu().numpy() | bad_jobs

    sl = slice(search_at, search_at + block)
    recons = rp.recons(batch.seqs[sl], rank_idx[sl], rank_valid[sl])
    args = (c, batch.dets[sl], recons, vl_t[sl], tense,
            res.scores.shape[1])
    _, _, ref_scores, margin = rc.beam_search(w["captioner"], *args)
    got_scores = res.scores[sl].float()
    if control is not None:
        with control.precision():
            got_scores = rc.beam_search(control.weights["captioner"],
                                        *args)[2]
    del recons
    judged = margin >= tr["search_tie"]
    search = torch.where(judged, ((got_scores - ref_scores).abs()
                                  / ref_scores.abs().clamp_min(1.0)).amax(1),
                         0.0)
    per_job_bad[sl] |= (search > limits["search_gap"]).cpu().numpy()
    return {"planner_gap": planner_gap, "sinkhorn_gap": sink_gap,
            "plan_exact": plan_exact, "beam_gap": float(beam_gap.max()),
            "search_gap": float(search.max()),
            "search_judged": int(judged.sum()),
            "failed": int(per_job_bad.sum()) if same_in else n_jobs}
