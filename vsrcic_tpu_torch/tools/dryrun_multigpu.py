"""Dry run of the port's data-parallel paths over N ranks at tiny shapes.

    python -m vsrcic_tpu_torch.tools.dryrun_multigpu N --platform cpu
    python -m vsrcic_tpu_torch.tools.dryrun_multigpu N            # N cards
    python -m vsrcic_tpu_torch.tools.dryrun_multigpu 2 --devices cuda:0,cuda:0

The counterpart of `__graft_entry__.dryrun_multichip` (`_dryrun_body`): on
N ranks started by `parallel.launch.run` (gloo on the CPU or where a card
is shared, NCCL on N cards), one XE step, one SCST step on a batch that
does not divide by N, both planner trainers on group and pair counts that
do not divide by N, and the sharded eval pipeline on jobs with an ambiguous
role, so that the Sinkhorn net runs in every phase's pad path. On a card
the fused attention, vocab top-k and Sinkhorn kernels run; on the CPU their
plain versions. Each step's loss must be finite and every rank must end
with the same parameters (a float64 checksum of each trainer's, gathered).
Prints one line per path; raises on any failure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _checksum_equal(params, mesh, what):
    import torch
    from vsrcic_tpu_torch.parallel.mesh import all_gather_blocks
    from vsrcic_tpu_torch.utils.params import flatten
    total = sum(float(v.double().sum()) for v in flatten(params).values())
    sums = all_gather_blocks(torch.tensor([total], dtype=torch.float64,
                                          device=mesh.device), mesh)
    if not bool((sums == sums[0]).all()):
        raise AssertionError("%s: the ranks' parameters differ (checksums "
                             "%s)" % (what, sums.tolist()))
    return total


def _body(devices):
    import torch
    from vsrcic_tpu_torch.metrics import Cider
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                shard_batch)
    from vsrcic_tpu_torch.pipelines import CaptionJob, EvalPipeline
    from vsrcic_tpu_torch.text import TextField
    from vsrcic_tpu_torch.train import (CaptionerSCSTTrainer,
                                        CaptionerXETrainer, SinkhornTrainer,
                                        SSPTrainer)

    mesh = make_mesh(len(devices), devices=devices)
    n = mesh.size
    card = mesh.device.type == "cuda"
    tag = "dryrun_multigpu(%d, %s)" % (n, mesh.backend)
    rng = np.random.RandomState(0)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # --- XE: compact ids, each rank's block of a batch of 2n -------------
    cfg = CaptionerConfig(seq_len=6, vocab_size=64, bos_idx=2,
                          det_feat_size=32, input_encoding_size=16,
                          rnn_size=12, att_size=8)
    xe = CaptionerXETrainer(cfg, replicate(init_captioner_params(gen(0), cfg),
                                           mesh), lr=1e-3, mesh=mesh)
    b = 2 * n
    batch = (rng.rand(b, 5, cfg.det_feat_size).astype(np.float32),
             rng.randint(0, cfg.vocab_size, (b, cfg.seq_len)),
             rng.randint(-1, 5, (b, cfg.seq_len, 3)),
             rng.randint(0, 2, (b, cfg.seq_len)))
    loss, lc, lg = xe.step(*shard_batch(batch, mesh))
    if not np.isfinite(loss):
        raise AssertionError("%s: XE loss %s" % (tag, loss))
    _checksum_equal(xe.state.params, mesh, "XE")
    print("%s: XE loss %.4f (cap %.4f gate %.4f) OK" % (tag, loss, lc, lg))

    # --- SCST: a batch of n + 1 (the pad path), fast decode on a card ----
    tf = TextField(fix_length=cfg.seq_len)
    caps = ["a dog runs", "a cat sits", "a dog sits", "a cat runs"]
    tf.build_vocab(caps, min_freq=1)
    cfg_rl = CaptionerConfig(seq_len=cfg.seq_len, vocab_size=len(tf.vocab),
                             bos_idx=tf.bos_idx,
                             det_feat_size=cfg.det_feat_size,
                             input_encoding_size=cfg.input_encoding_size,
                             rnn_size=cfg.rnn_size, att_size=cfg.att_size)
    scst = CaptionerSCSTTrainer(
        cfg_rl, replicate(init_captioner_params(gen(1), cfg_rl), mesh), tf,
        Cider(), lr=1e-3, mesh=mesh, fast_decode=card,
        table_dtype=torch.bfloat16 if card else None)
    b_rl = n + 1
    rl_loss, rl_adv = scst.step(
        rng.rand(b_rl, 5, cfg.det_feat_size).astype(np.float32),
        rng.rand(b_rl, cfg.seq_len, 3, cfg.det_feat_size).astype(np.float32),
        [caps[i % len(caps)] for i in range(b_rl)],
        torch.Generator(device=mesh.device).manual_seed(3))
    if not (np.isfinite(rl_loss) and np.isfinite(rl_adv)):
        raise AssertionError("%s: SCST loss %s adv %s" % (tag, rl_loss,
                                                          rl_adv))
    _checksum_equal(scst.state.params, mesh, "SCST")
    print("%s: SCST loss %.4f adv %.4f (batch %d) OK"
          % (tag, rl_loss, rl_adv, b_rl))

    # --- planner trainers: n + 3 groups, n + 5 pairs ---------------------
    ssp_cfg = SSPConfig(hidden_size=16, embed_size=16, encoder_layers=1,
                        decoder_layers=1)
    ssp = SSPTrainer(ssp_cfg, replicate(init_ssp_params(gen(6), ssp_cfg),
                                        mesh), mesh=mesh)
    g = n + 3
    ssp_loss = ssp.step(
        rng.randint(1, 50, (g, 1)).astype(np.float64),
        rng.randint(0, 5, (g, ssp_cfg.max_len)).astype(np.float64),
        np.where(rng.rand(g, ssp_cfg.max_len) < 0.6,
                 rng.randint(1, 5, (g, ssp_cfg.max_len)), 0).astype(float),
        torch.Generator(device=mesh.device).manual_seed(7))
    kcfg = SinkhornConfig(n=4, n_iters=5, tau=0.1, txt_dim=6, vis_dim=8,
                          pos_dim=2)
    sink = SinkhornTrainer(kcfg, replicate(init_sinkhorn_params(gen(8), kcfg),
                                           mesh), mesh=mesh)
    q = n + 5
    sink_loss = sink.step(rng.rand(q, 4, 16).astype(np.float32),
                          rng.rand(q, 4).astype(np.float32),
                          rng.rand(q, 4).astype(np.float32), n_images=4)
    if not (np.isfinite(ssp_loss) and np.isfinite(sink_loss)):
        raise AssertionError("%s: planner losses %s %s"
                             % (tag, ssp_loss, sink_loss))
    _checksum_equal(ssp.state.params, mesh, "S-SSP")
    _checksum_equal(sink.state.params, mesh, "Sinkhorn")
    print("%s: planner trainers S-SSP %.4f (%d groups) Sinkhorn %.4f "
          "(%d pairs) OK" % (tag, ssp_loss, g, sink_loss, q))

    # --- the sharded eval pipeline: n + 1 jobs, an ambiguous role --------
    cap = ControllableCaptioner(
        cfg_rl, params=scst.state.params, verb_2_vob_all={"3": [5, 6]},
        use_fused_attention=card, use_vocab_topk=card,
        table_dtype=torch.bfloat16 if card else None, device=mesh.device)
    pcfg = SSPConfig(hidden_size=32, embed_size=32)
    scfg = SinkhornConfig()
    pipe = EvalPipeline(cap, init_ssp_params(gen(4), pcfg), pcfg,
                        init_sinkhorn_params(gen(5), scfg), scfg,
                        eos_word=tf.eos_idx, beam_size=2, mesh=mesh)
    L, M = 10, 3
    jobs = []
    for _ in range(n + 1):
        job = CaptionJob(
            seqs_vis=rng.rand(L, 2048).astype(np.float32),
            seqs_txt=rng.rand(L, 300).astype(np.float32),
            seqs_pos=rng.rand(L, 4).astype(np.float32),
            seqs_all=rng.rand(L, M, cfg.det_feat_size).astype(np.float32),
            control_verb=np.array([3.0, 0, 0, 0, 0, 0, 0, 0]),
            det_seqs_v=np.zeros((L, 8)), det_seqs_sr=np.zeros((L, 8)),
            verb_list=np.full((L, 1), -1.0))
        job.det_seqs_v[:3, 0] = 3.0
        job.det_seqs_sr[0, 0] = job.det_seqs_sr[1, 0] = 2.0  # ambiguous
        job.det_seqs_sr[2, 0] = 7.0
        jobs.append(job)
    dets = rng.rand(len(jobs), 6, cfg.det_feat_size).astype(np.float32)
    words = pipe.run_batch(dets, jobs)
    if words.shape != (len(jobs), cfg.seq_len):
        raise AssertionError("%s: pipeline words %s" % (tag, words.shape))
    print("%s: sharded eval pipeline %s OK" % (tag, words.shape))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--platform", default=None,
                   help="cpu: n processes on the CPU; else n cards")
    p.add_argument("--devices", default=None,
                   help="one device per rank, comma-separated (e.g. "
                   "cuda:0,cuda:0: two ranks sharing one card, on gloo)")
    opt = p.parse_args(argv)
    from vsrcic_tpu_torch.cli.common import data_parallel_devices
    from vsrcic_tpu_torch.parallel.launch import run
    devices = (opt.devices.split(",") if opt.devices
               else data_parallel_devices(opt.n, opt.platform))
    if len(devices) != opt.n:
        p.error("%d devices for %d ranks" % (len(devices), opt.n))
    return run(_body, devices, devices)


if __name__ == "__main__":
    sys.exit(main())
