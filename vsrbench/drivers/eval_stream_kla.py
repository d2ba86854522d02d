"""The eval stream with Kimi-Linear-48B-A3B's language model as the caption
decoder: `eval_stream_vlm`'s run (one caller, `EvalPipeline.run_stream`
one batch ahead, a pool of batches made in set-up, the same traffic
parameters, spans and slice), with this model's weights and facade
(`KimiLinearCaptioner`), the KDA layers' span `vlm.kda` joined to its
device operations, and this model's reference in the check.

The check: `eval_stream_vlm`'s numbers (`planner_gap`, `sinkhorn_gap`,
`plan_exact`, `route_gap`, `logit_gap`, `beam_gap`, `cut_gap`,
`yield_exact`) against `reference/kimi_linear_lm.py`, and `state_gap`:
one KDA layer's recurrence at one step and job, drawn from the seed before
set-up (the facade's probe copies its inputs and output as the timed path
computed them, CUDA graph replays included), against the equation from
the same inputs in f32 (`kimi_linear_lm.judge_recurrence`), in each
checked batch.

End-to-end: `captions_per_s`, `batch_p95_ms`, `setup_s` (as
`eval_stream`'s).
"""
from __future__ import annotations

import types
from types import SimpleNamespace

import numpy as np

from vsrbench import harness, weights
from vsrbench import yardstick as ys
from vsrbench import yardstick_kla as yk
from vsrbench.drivers import eval_stream as es
from vsrbench.drivers import eval_stream_vlm as ev

SPANS = ("vlm.attn", "vlm.moe", "vlm.kda")
NUMBERS = ev.NUMBERS + ("state_gap",)


def _over(fn, **names):
    """`fn` with some of its module's names (`eval_stream_vlm`'s) bound to
    `names` instead."""
    return types.FunctionType(fn.__code__, dict(fn.__globals__, **names),
                              fn.__name__, fn.__defaults__, fn.__closure__)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def kla_config(cfg):
    from vsrcic_tpu_torch.models.kimi_linear import KimiLinearConfig
    cap = cfg["captioner"]
    return KimiLinearConfig.from_published(
        cfg, det_feat_size=cap["det_feat_size"], seq_len=cap["seq_len"],
        bos_idx=cap["bos_idx"])


def make_kla(cfg, gen, device):
    """The decoder's weights from `gen`, one draw a leaf in the order of
    `kimi_linear.param_shapes`, on the device, by the configuration's
    `weights` group: normal (0, std) matrices, unit norms, zero biases,
    stored in its dtype; the router's correction bias normal (0,
    router_bias_std), A_log = log A with A uniform in `decay_a`, dt_bias
    the inverse softplus of dt log-uniform in `decay_dt`, in f32; the
    conv weights uniform in `conv`. Drawn here, as `weights.py` draws the
    other models', so that no initialiser of the program sets the
    benchmark's inputs."""
    import torch
    from vsrcic_tpu_torch.models.kimi_linear import nest, param_shapes
    kc = kla_config(cfg)
    ws = cfg["weights"]
    dtype = getattr(torch, ws["dtype"])
    flat = {}
    for name, shape in param_shapes(kc).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_norm", "kv_norm", "mlp_norm", "norm", "o_norm"):
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf == "bias":
            flat[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif leaf == "router_bias":
            flat[name] = torch.randn(shape, generator=gen, device=device
                                     ) * ws["router_bias_std"]
        elif leaf in ("conv", "A_log", "dt_bias"):
            u = torch.rand(shape, generator=gen, device=device)
            if leaf == "conv":
                lo, hi = ws["conv"]
                flat[name] = (lo + (hi - lo) * u).to(dtype)
            elif leaf == "A_log":
                lo, hi = ws["decay_a"]
                flat[name] = torch.log(lo + (hi - lo) * u)
            else:
                lo, hi = np.log(ws["decay_dt"])
                dt = torch.exp(lo + (hi - lo) * u)
                flat[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            flat[name] = (torch.randn(shape, generator=gen, device=device)
                          .mul_(ws["std"]).to(dtype))
    return kc, nest(flat, kc.num_hidden_layers)


def make_weights(cfg, seed, device):
    plan = cfg["plan"]
    gen = harness.torch_gen(seed, device, 1)
    w = {"planner": weights.make(weights.planner_leaves(
        cfg["planner"], plan["n_verbs"]), gen, device),
        "sinkhorn": weights.make(weights.sinkhorn_leaves(cfg["sinkhorn"]),
                                 gen, device)}
    w["kimi_cfg"], w["kimi"] = make_kla(cfg, harness.torch_gen(
        seed, device, 3), device)
    w["tense_map"], w["tense_ids"] = weights.tense_table(
        plan["n_verbs"], cfg["vocab_size"], plan["tenses"],
        harness.numpy_rng(seed, 2))
    w["probe"] = probe_of(cfg, seed)
    return w


def probe_of(cfg, seed):
    """The probed (KDA layer, step, job), drawn from the seed (the job
    taken modulo a batch's jobs by the facade)."""
    c = yk.model(cfg)
    rng = harness.numpy_rng(seed, 31)
    return (int(rng.integers(len(c["kda_layers"]))),
            int(rng.integers(c["seq_len"])), int(rng.integers(2 ** 31)))


def build_program(cfg, w, device):
    """`eval_stream_vlm.build_program` with this model's facade, its
    probe set (`probe_of`)."""
    from vsrcic_tpu_torch.models.kimi_linear import KimiLinearCaptioner
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.pipelines.eval_pipeline import EvalPipeline
    prog, plan = cfg["program"], cfg["plan"]
    captioner = KimiLinearCaptioner(w["kimi_cfg"], w["kimi"],
                                    verb_2_vob_all=w["tense_map"],
                                    device=device)
    captioner.probe = w["probe"]
    pl = {k: v for k, v in cfg["planner"].items()
          if k in SSPConfig.__dataclass_fields__}
    return EvalPipeline(
        captioner, weights.clone(w["planner"]), SSPConfig(**pl),
        weights.clone(w["sinkhorn"]), SinkhornConfig(**cfg["sinkhorn"]),
        eos_word=plan["eos_word"], fixed_len=plan["fixed_len"],
        sinkhorn_len=cfg["sinkhorn"]["n"], beam_size=prog["beam_size"],
        gt=False, fast_ssp=prog["fast_ssp"], device=device)


def pool_stats(cfg, tr, pool):
    """Per pool batch: the jobs' real detections (host list) and the
    operations of its plan and control tokens (`yardstick`,
    `yardstick_vlm`); the decoder's are counted at read time, at the held
    experts' share of the pairs (`metrics/mfu_pct.kla.py`)."""
    from vsrbench import yardstick_vlm as yv
    c = yk.model(cfg)
    shape = es.shape_of(cfg, tr)
    plan = (ys.ssp_flops(cfg["planner"], shape["groups"],
                         shape["planner_tokens"], shape["planner_steps"])
            + ys.sinkhorn_flops(cfg["sinkhorn"], shape["groups"],
                                shape["pairs"])
            + yv.control_flops(c, tr["jobs"], cfg["plan"]["fixed_len"],
                               cfg["plan"]["regions"]))
    return [SimpleNamespace(n_real=(b.dets.sum(-1) != 0).sum(1).tolist(),
                            plan_flops=plan) for b in pool]


class SpanTracer(ev.SpanTracer):
    """`eval_stream_vlm.SpanTracer` over `SPANS` (`vlm.kda` too)."""
    _reduce = _over(ev.SpanTracer._reduce, SPANS=SPANS)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def ref_config(cfg, **control):
    """The reference's configuration: the model's keys, the first expert
    held, and the control's precisions."""
    return dict(yk.model(cfg), first_expert=0, **control)


def judge_batch(cfg, tr, w, batch, out, limits, judge_at, step,
                control=None):
    """`eval_stream_vlm.judge_batch` against this model's reference
    (`kimi_linear_lm`), and `state_gap` from the batch's probe.

    `control` (vsrbench/control_kla.py): an object with `config`, the
    reference's configuration one precision below the program's (the KDA
    state in bf16, or the expert products on float8 inputs). Given, the
    reference at that precision stands in the program's place along the
    served paths with its own expert choices, keeps its own K best
    children of the step's live beams, and computes the probed step."""
    import torch
    from vsrbench.reference import kimi_linear_lm as ref
    from vsrbench.reference import plan as rp
    (planner_gap, sink_gap, plan_exact, bad, rank_idx, rank_valid,
     verb_lists, same_in) = ev.judge_plan(cfg, w, batch, out)
    c = ref_config(cfg)
    dev = batch.dets.device
    tense = torch.from_numpy(w["tense_ids"]).to(dev)
    vl_t = torch.from_numpy(verb_lists).long().to(dev)
    res = out["beam"]
    per_job_bad = bad.copy()

    sl = slice(judge_at, judge_at + tr["judge_block"])
    recons = rp.recons(batch.seqs[sl], rank_idx[sl], rank_valid[sl])
    served = {k: getattr(res, k)[sl] for k in ev.SERVED}
    served["prefix_routes"] = res.prefix_routes[sl]
    steps = {k: getattr(res, k)[sl] for k in ev.STEPS}
    steps["prefix_routes"] = served["prefix_routes"]
    args = (batch.dets[sl], recons, vl_t[sl], tense)
    chosen, mine = None, None
    if control is not None:
        own = dict(served)
        del own["routes"]
        served = ref.judge_beams(w["kimi"], control.config, *args, own,
                                 cfg["plan"]["eos_word"])["paths"]
        del steps["step_routes"], steps["prefix_routes"]
        _, chosen = ref.judge_cut(w["kimi"], control.config, *args, steps,
                                  step)
        _, mine = ref.judge_recurrence(res.probe, control.config)
    jb = ref.judge_beams(w["kimi"], c, *args, served,
                         cfg["plan"]["eos_word"])
    cut, _ = ref.judge_cut(w["kimi"], c, *args, steps, step, chosen)
    state_gap, _ = ref.judge_recurrence(res.probe, c, mine)
    gaps = {"route_gap": jb["route"], "logit_gap": jb["logit"],
            "beam_gap": jb["beam"], "cut_gap": cut}
    worst = {k: float(v.max()) for k, v in gaps.items()}
    for k, v in gaps.items():
        per_job_bad[sl] |= (v > limits[k]).cpu().numpy()
    job = int(res.probe["rows"][0]) // res.words.shape[1]
    per_job_bad[job] |= float(state_gap) > limits["state_gap"]
    del recons, jb
    return dict(worst, planner_gap=planner_gap, sinkhorn_gap=sink_gap,
                plan_exact=plan_exact, state_gap=float(state_gap),
                failed=int(per_job_bad.sum()) if same_in
                else len(per_job_bad))


def judge(cfg, tr, w, pool, outputs, seed, limits, control=None):
    """`eval_stream_vlm.judge` through this module's `judge_batch`, with
    `state_gap` among the numbers."""
    return _over(ev.judge, judge_batch=judge_batch, NUMBERS=NUMBERS)(
        cfg, tr, w, pool, outputs, seed, limits, control)


def run(cell, args, device, t_process):
    """`eval_stream_vlm.run` with this module's weights, facade, pool
    statistics, span tracer and check."""
    return _over(ev.run, make_weights=make_weights,
                 build_program=build_program, pool_stats=pool_stats,
                 judge=judge, SpanTracer=SpanTracer)(cell, args, device,
                                                     t_process)
