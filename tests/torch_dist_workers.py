"""Rank functions of the port's data-parallel tests
(tests/test_torch_parallel*.py).

`run_world(n, out_dir, **cases)` runs each case on one world of n gloo
ranks on the CPU through `vsrcic_tpu_torch.parallel.launch.run` (one spawn
for them all) and returns every rank's results: each rank writes
`out_dir/w<n>/<case>_rank<r>.npz`. The spawned ranks
import this module, never a test module (tests/conftest.py imports JAX), so
it imports neither JAX nor the JAX package: the tests compute the JAX side
in their own process and pass the ranks numpy inputs and parameters.
"""
from __future__ import annotations

import os

import numpy as np


def run_world(n: int, out_dir, **cases):
    """Every case of `cases` ({case name: its inputs}) in turn on one world
    of n ranks: {case: [{name: array} of rank r for r in range(n)]}; rank
    0's return value of a case is under "__result__" of its rank-0 dict
    when it is not None."""
    from vsrcic_tpu_torch.parallel.launch import run
    path = os.path.join(str(out_dir), "w%d" % n)
    os.makedirs(path, exist_ok=True)
    rets = run(_rank_main, ["cpu"] * n, path, cases)
    out = {}
    for case in cases:
        out[case] = []
        for r in range(n):
            with np.load(os.path.join(path, "%s_rank%d.npz" % (case, r))) as z:
                out[case].append({k: z[k] for k in z.files})
        if rets[case] is not None:
            out[case][0]["__result__"] = rets[case]
    return out


def _rank_main(path, cases):
    import torch
    from vsrcic_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(devices=["cpu"] * torch.distributed.get_world_size())
    rets = {}
    for case, inputs in cases.items():
        res = {}
        rets[case] = CASES[case](mesh, res, **inputs)
        np.savez(os.path.join(path, "%s_rank%d.npz" % (case, mesh.rank)),
                 **{k: np.asarray(v) for k, v in res.items()})
    return rets


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _put_params(res, prefix, params):
    from vsrcic_tpu_torch.utils.params import flatten
    for k, v in flatten(params).items():
        res[prefix + k] = _np(v)


# ---------------------------------------------------------------------------
# cases: each fills `res` with this rank's results
# ---------------------------------------------------------------------------

def mesh_case(mesh, res, batch, tree):
    """shard_batch blocks, replicate, all_reduce_tree, all_gather_blocks
    and the mesh's refusals."""
    import torch
    from vsrcic_tpu_torch.parallel import mesh as pm
    for k, v in pm.shard_batch(batch, mesh).items():
        res["block/" + k] = _np(v)
    from vsrcic_tpu_torch.utils.params import flatten, unflatten
    mine = unflatten({k: torch.from_numpy(v) * (mesh.rank + 1)
                      for k, v in flatten(tree).items()})
    _put_params(res, "replicated/", pm.replicate(mine, mesh))
    _put_params(res, "summed/", pm.all_reduce_tree(mine, mesh))
    res["gathered"] = _np(pm.all_gather_blocks(
        torch.full((2, 3), float(mesh.rank)), mesh))
    for name, kw in (("model_axis", dict(n_model=2)),
                     ("world", dict(n_data=mesh.size + 1))):
        try:
            pm.make_mesh(**kw)
        except ValueError as e:
            res["refused/" + name] = str(e)
    print("rank %d prints" % mesh.rank)
    return "rank 0's result"


def fail_case(mesh, res):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.barrier()


def _captioner(cfg, params, verbs, mesh, fast):
    """fast: None (strict) or the kernels' switches with "f32" or "bf16"
    tables (their plain versions on the CPU)."""
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.utils.params import params_from_jax
    kw = {}
    if fast is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  table_dtype=torch.bfloat16 if fast == "bf16" else None)
    return ControllableCaptioner(
        CaptionerConfig(**cfg), params=params_from_jax(params),
        verb_2_vob_all=verbs, device=mesh.device, **kw)


def beam_case(mesh, res, cfg, params, verbs, runs, eos):
    """For each run {name: dict(fast, dets, groups, verb_list, beam_size)}:
    sharded_beam_search_v, and this rank's block through the single-device
    call; sharded_greedy on the first run's inputs."""
    from vsrcic_tpu_torch.parallel import (sharded_beam_search_v,
                                           sharded_greedy)
    for name, r in runs.items():
        cap = _captioner(cfg, params, verbs, mesh, r["fast"])
        args = (r["dets"], r["groups"], r["verb_list"])
        out = sharded_beam_search_v(cap, mesh, *args, eos_word=eos,
                                    beam_size=r["beam_size"])
        lo, hi = mesh.bounds(len(args[0]))
        own = cap.beam_search_v(*(a[lo:hi] for a in args), eos_word=eos,
                                beam_size=r["beam_size"])
        for f in out._fields:
            res["%s/%s" % (name, f)] = _np(getattr(out, f))
            res["%s/own/%s" % (name, f)] = _np(getattr(own, f))
        if "greedy/words" not in res:
            words, gates = sharded_greedy(cap, mesh, *args[:2])
            res["greedy/words"], res["greedy/gates"] = _np(words), _np(gates)


def xe_case(mesh, res, cfg, params, batch, lr, steps):
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.parallel.mesh import replicate, shard_batch
    from vsrcic_tpu_torch.train import CaptionerXETrainer
    tr = CaptionerXETrainer(CaptionerConfig(**cfg), replicate(params, mesh),
                            lr=lr, mesh=mesh)
    block = shard_batch(batch, mesh)
    res["losses"] = [tr.step(*block) for _ in range(steps)]
    _put_params(res, "params/", tr.state.params)


def _text_field(words, seq_len):
    from vsrcic_tpu_torch.text import TextField
    tf = TextField(fix_length=seq_len)
    tf.build_vocab([" ".join(words)], min_freq=1)
    return tf


def scst_case(mesh, res, cfg, params, words_vocab, dets, groups, gts,
              traj, lr, seed):
    """The grad step on given trajectories; the strict sampled decode of
    the whole batch; a fast-decode step and its rank's sampled decode."""
    import torch
    from vsrcic_tpu_torch.decode.loops import forced_feedback_logprobs
    from vsrcic_tpu_torch.metrics import Cider
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   precompute_statics)
    from vsrcic_tpu_torch.parallel.mesh import replicate
    from vsrcic_tpu_torch.train import CaptionerSCSTTrainer
    from vsrcic_tpu_torch.train.common import rank_generator
    c = CaptionerConfig(**cfg)
    tf = _text_field(words_vocab, c.seq_len)
    tr = CaptionerSCSTTrainer(c, replicate(params, mesh), tf, Cider(), lr=lr,
                              mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    ((w, g), (wl, gl)), base = tr._decode_batch(
        torch.from_numpy(dets), torch.from_numpy(groups), gen)
    for k, v in (("words", w), ("gates", g), ("word_logps", wl),
                 ("gate_logps", gl), ("greedy", base)):
        res["sampled/" + k] = _np(v)
    res["grad_loss"] = tr.grad_step(dets, groups, *traj)
    _put_params(res, "grad_params/", tr.state.params)

    fast = CaptionerSCSTTrainer(c, replicate(params, mesh), tf, Cider(),
                                lr=lr, mesh=mesh, fast_decode=True)
    loss, adv = fast.step(dets, groups, gts,
                          torch.Generator().manual_seed(seed))
    res["fast/loss"], res["fast/adv"] = loss, adv
    _put_params(res, "fast_params/", fast.state.params)
    # this rank's own stream: its block's draws and their logprobs
    lo, hi = mesh.bounds(len(dets))
    det, grp = (torch.from_numpy(x[lo:hi]) for x in (dets, groups))
    gen = rank_generator(torch.Generator().manual_seed(seed), mesh)
    ((w, g), (wl, gl)), _ = fast.decode(det, grp, gen, greedy=False)
    params = fast.state.params
    fw, fg = forced_feedback_logprobs(
        params, c, precompute_statics(params, c, det, grp), w, g)
    res["fast/words"], res["fast/word_logps"] = _np(w), _np(wl)
    res["fast/forced_word_logps"] = _np(fw)
    res["fast/gate_logps"], res["fast/forced_gate_logps"] = _np(gl), _np(fg)
    res["fast/seed"] = gen.initial_seed()


def planners_case(mesh, res, ssp_cfg, ssp_params, ssp_batch, sink_cfg,
                  sink_params, sink_batch, lr, steps):
    import torch
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.parallel.mesh import all_reduce_tree, replicate
    from vsrcic_tpu_torch.train import SinkhornTrainer, SSPTrainer
    ssp = SSPTrainer(SSPConfig(**ssp_cfg), replicate(ssp_params, mesh),
                     lr=lr, mesh=mesh)
    _put_params(res, "ssp/grads/", all_reduce_tree(
        ssp.loss_and_grads(*ssp_batch)[1], mesh))
    res["ssp/losses"] = [
        ssp.step(*ssp_batch, torch.Generator().manual_seed(i))
        for i in range(steps)]
    _put_params(res, "ssp/params/", ssp.state.params)
    inputs, tr_locs, gt_locs, n_images = sink_batch
    for norm in ("images", "pairs"):
        sk = SinkhornTrainer(SinkhornConfig(**sink_cfg),
                             replicate(sink_params, mesh), lr=lr,
                             loss_normalization=norm, mesh=mesh)
        _put_params(res, "sink_%s/grads/" % norm, all_reduce_tree(
            sk.loss_and_grads(inputs, tr_locs, gt_locs, n_images)[1], mesh))
        res["sink_%s/losses" % norm] = [
            sk.step(inputs, tr_locs, gt_locs, n_images=n_images)
            for _ in range(steps)]
        _put_params(res, "sink_%s/params/" % norm, sk.state.params)


def pipeline_case(mesh, res, cfg, verbs, params, ssp_cfg, sink_cfg, eos,
                  beam_size, batches):
    """EvalPipeline(mesh=...), strict and through the kernels' plain
    versions on bf16 tables: run_batch and plan_batch's recons on each
    batch, then run_stream over all of them."""
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    from vsrcic_tpu_torch.pipelines import CaptionJob, EvalPipeline
    from vsrcic_tpu_torch.utils.params import params_from_jax
    for path, fast in (("strict", None), ("fast_bf16", "bf16")):
        cap = _captioner(cfg, params["captioner"], verbs, mesh, fast)
        pipe = EvalPipeline(cap, params_from_jax(params["ssp"]),
                            SSPConfig(**ssp_cfg),
                            params_from_jax(params["sinkhorn"]),
                            SinkhornConfig(**sink_cfg), eos_word=eos,
                            beam_size=beam_size, mesh=mesh)
        stream = []
        for i, (dets, fields) in enumerate(batches):
            jobs = [CaptionJob(**{f: v[p] for f, v in fields.items()})
                    for p in range(len(dets))]
            res["%s/b%d/words" % (path, i)] = pipe.run_batch(dets, jobs)
            res["%s/b%d/recons" % (path, i)] = pipe.plan_batch(jobs)[0]
            stream.append((dets, jobs))
        for i, words in enumerate(pipe.run_stream(stream)):
            res["%s/b%d/stream" % (path, i)] = words


CASES = {f.__name__[:-len("_case")]: f for f in (
    mesh_case, fail_case, beam_case, xe_case, scst_case, planners_case,
    pipeline_case)}
