"""Full eval pipeline CLI — reference coco_scripts/eval_coco.py /
flickr_scripts/eval_flickr.py equivalent: SSP composition + joint beam search
+ metric table.

    python -m vsrcic_tpu_torch.cli.eval --synthetic --limit 4
    python -m vsrcic_tpu_torch.cli.eval --det --gt ...
    python -m vsrcic_tpu_torch.cli.eval --synthetic --platform cpu --limit 4

Counterpart of `vsrcic_tpu/cli/eval.py`, with its flags, output and dump
format. It runs on the CUDA card unless `--platform cpu` is given; with no
card it raises. `--fused`, `--vocab_topk` and `--bf16_tables` select the
hand-written kernels (their plain versions on the CPU). Untrained weights
come from `torch.Generator`s seeded from --seed, which cannot reproduce the
JAX CLI's `jax.random` draws: the two CLIs agree when they start from the
same checkpoints.
"""
from __future__ import annotations

import time

import numpy as np

from vsrcic_tpu_torch.cli.common import (base_parser, build_world,
                                         data_parallel_mesh, resolve_device,
                                         seed_all)
from vsrcic_tpu_torch.cli.fields import (make_eval_det_field,
                                         make_image_field,
                                         unpack_eval_output)


def main(argv=None):
    p = base_parser(batch_size=16)
    p.add_argument("--sinkhorn_len", default=10, type=int)
    p.add_argument("--fixed_len", default=10, type=int)
    p.add_argument("--beam_size", default=5, type=int)
    p.add_argument("--det", action="store_true",
                   help="use detected regions")
    p.add_argument("--gt", action="store_true", help="use gt verb")
    p.add_argument("--limit", default=None, type=int,
                   help="evaluate only the first N images")
    p.add_argument("--captioner_ckpt", default=None, type=str)
    p.add_argument("--ssp_ckpt", default=None, type=str)
    p.add_argument("--sinkhorn_ckpt", default=None, type=str)
    p.add_argument("--fused", action="store_true",
                   help="use the fused attention CUDA kernel")
    p.add_argument("--bf16_tables", action="store_true",
                   help="store beam statics tables in bf16 (fast path)")
    p.add_argument("--vocab_topk", action="store_true",
                   help="use the streaming vocab top-k CUDA kernel + "
                   "candidate beam (fast path)")
    p.add_argument("--fast_ssp", default=1, type=int,
                   help="KV-cached incremental planner decode (token-exact "
                   "vs the full-buffer path; 0 = strict full-buffer)")
    p.add_argument("--data_parallel", default=0, type=int,
                   help="shard the beam over N devices (not ported yet: "
                   "only 0, a single device)")
    p.add_argument("--dump_preds", default=None, type=str,
                   help="write decoded/gt caption pairs as JSON lines "
                   "(used by scripts/fastpath_metric_delta.py and the "
                   "real-data parity runbook, docs/MIGRATION.md)")
    opt = p.parse_args(argv)
    print(opt)
    device = resolve_device(opt.platform)
    data_parallel_mesh(opt.data_parallel, None)   # raises unless 0
    seed_all(opt.seed)

    import torch
    from vsrcic_tpu_torch.core.checkpoint import restore_checkpoint
    from vsrcic_tpu_torch.data import DataLoader, DictionaryDataset, RawField
    from vsrcic_tpu_torch.metrics import (Bleu, Cider,
                                          ExternalMetricUnavailable, Meteor,
                                          NativeMeteor, NativeSpice, Rouge,
                                          Spice)
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.pipelines import CaptionJob, EvalPipeline
    from vsrcic_tpu_torch.text import dedup_join, ptb_tokenize

    world = build_world(opt)
    tf = world.text_field
    _, _, test_ex = world.splits
    if opt.limit:
        seen, kept = set(), []
        for e in test_ex:
            seen.add(e.image)
            if len(seen) > opt.limit:
                break
            kept.append(e)
        test_ex = kept

    image_field = make_image_field(world, opt)
    det_field = make_eval_det_field(world, opt)

    ds = DictionaryDataset(test_ex, {"image": image_field,
                                     "detection": det_field,
                                     "text": RawField()}, "image")
    from vsrcic_tpu_torch.data import PrefetchLoader
    loader = PrefetchLoader(
        DataLoader(ds, batch_size=opt.batch_size,
                   num_workers=opt.nb_workers),
        depth=2)  # field preprocess of batch k+1 overlaps batch k's decode

    # models
    cfg = CaptionerConfig(seq_len=20, vocab_size=len(tf.vocab),
                          bos_idx=tf.bos_idx, det_feat_size=opt.feat_dim,
                          input_encoding_size=opt.input_encoding_size,
                          rnn_size=opt.rnn_size, att_size=opt.att_size)
    cap_params = None
    if opt.captioner_ckpt:
        if opt.captioner_ckpt.endswith(".pth"):
            from vsrcic_tpu_torch.utils.torch_import import \
                import_torch_state_dict
            cap_params = import_torch_state_dict(opt.captioner_ckpt)
        else:
            blob = restore_checkpoint(opt.captioner_ckpt)
            cap_params = blob["params"]
            if "cfg" in blob:
                # rebuild the model with the hyperparams stored at train
                # time instead of requiring re-matched CLI dim flags (the
                # reference reads its `opt` back out of the checkpoint,
                # eval_coco.py:39-40)
                c = {k: (bool(v) if k.endswith("lstm") else int(v))
                     for k, v in blob["cfg"].items()}
                if c["vocab_size"] != len(tf.vocab):
                    # a mismatched vocab can't decode meaningfully (and a
                    # larger ckpt vocab would index past the world's itos)
                    raise SystemExit(
                        "checkpoint vocab_size %d != world vocab %d — the "
                        "checkpoint was trained against a different "
                        "vocabulary; point --coco_root/--flickr_root (or "
                        "--synthetic_images/seed) at the matching world"
                        % (c["vocab_size"], len(tf.vocab)))
                cfg = CaptionerConfig(**c)
    # on the CPU the kernels' wrappers run their plain versions, so the
    # same switches serve both devices
    captioner = ControllableCaptioner(
        cfg, params=cap_params, seed=opt.seed,
        verb_2_vob_all=world.verb_2_vob_all,
        use_fused_attention=opt.fused,
        use_vocab_topk=opt.vocab_topk,
        table_dtype=torch.bfloat16 if opt.bf16_tables else None,
        device=device)

    ssp_cfg = SSPConfig(dataset=opt.dataset)
    if opt.ssp_ckpt:
        if opt.ssp_ckpt.endswith(".pth"):
            from vsrcic_tpu_torch.utils.torch_import import \
                import_torch_state_dict
            ssp_params = import_torch_state_dict(opt.ssp_ckpt)
        else:
            sblob = restore_checkpoint(opt.ssp_ckpt)
            ssp_params = sblob["params"]
            if "cfg" in sblob:
                # reduced-width planner ckpts load under the default
                # 512/512/3 config WITHOUT a shape error (sqrt(embed)
                # scaling differs) — the stored cfg must win
                c = sblob["cfg"]
                ds = ("coco" if int(c["dataset_id"]) == 0 else "flickr") \
                    if "dataset_id" in c else opt.dataset
                ssp_cfg = SSPConfig(
                    dataset=ds,
                    hidden_size=int(c["hidden_size"]),
                    embed_size=int(c["embed_size"]),
                    encoder_layers=int(c["encoder_layers"]),
                    decoder_layers=int(c["decoder_layers"]),
                    max_len=int(c.get("max_len", 10)))
    else:
        ssp_params = init_ssp_params(
            torch.Generator().manual_seed(opt.seed + 1), ssp_cfg)

    kcfg = SinkhornConfig(n=opt.sinkhorn_len, n_iters=20, tau=0.1,
                          vis_dim=opt.feat_dim)
    if opt.sinkhorn_ckpt:
        if opt.sinkhorn_ckpt.endswith(".pth"):
            from vsrcic_tpu_torch.utils.torch_import import \
                import_torch_state_dict
            kparams = import_torch_state_dict(opt.sinkhorn_ckpt)
        else:
            kblob = restore_checkpoint(opt.sinkhorn_ckpt)
            kparams = kblob["params"]
            if "cfg" in kblob:
                c = kblob["cfg"]
                kcfg = SinkhornConfig(
                    n=int(c["n"]), n_iters=int(c["n_iters"]),
                    tau=float(c["tau"]), txt_dim=int(c["txt_dim"]),
                    vis_dim=int(c["vis_dim"]), pos_dim=int(c["pos_dim"]))
    else:
        kparams = init_sinkhorn_params(
            torch.Generator().manual_seed(opt.seed + 2), kcfg)

    pipe = EvalPipeline(captioner, ssp_params, ssp_cfg, kparams, kcfg,
                        eos_word=tf.eos_idx, fixed_len=opt.fixed_len,
                        sinkhorn_len=opt.sinkhorn_len,
                        beam_size=opt.beam_size, gt=opt.gt,
                        fast_ssp=bool(opt.fast_ssp), device=device)

    predictions, gt_captions = [], []
    t0 = time.time()

    def batch_stream():
        # job unpacking (host) interleaves with the in-flight device work;
        # run_stream enqueues batch k+1's plan before batch k's beam so
        # every plan readback rides under a running beam
        for keys, values in loader:
            detections, img_ids = keys
            det_per_job, jobs = [], []
            for i in range(detections.shape[0]):
                for out, cap in zip(values["detection"][i],
                                    values["text"][i]):
                    (word, vis, pos, vis_all, seq_v, seq_sr, cv,
                     vl) = unpack_eval_output(out, opt.dataset, opt.det)
                    jobs.append(CaptionJob(
                        seqs_vis=vis, seqs_txt=word, seqs_pos=pos,
                        seqs_all=vis_all, control_verb=cv, det_seqs_v=seq_v,
                        det_seqs_sr=seq_sr, verb_list=vl))
                    det_per_job.append(detections[i])
                    gt_captions.append(cap)
            yield np.stack(det_per_job), jobs

    for words in pipe.run_stream(batch_stream()):
        predictions.extend(list(words))
    dt = time.time() - t0
    print("decoded %d captions in %.2fs (%.1f captions/s)"
          % (len(predictions), dt, len(predictions) / max(dt, 1e-9)))

    gen, gts = {}, {}
    for i, (pred, cap) in enumerate(zip(predictions, gt_captions)):
        gen[i] = [dedup_join(tf.decode(pred, join_words=False))]
        gts[i] = [cap]
    if opt.dump_preds:
        import json
        with open(opt.dump_preds, "w") as f:
            for i in gen:
                f.write(json.dumps({"i": i, "pred": gen[i][0],
                                    "gt": gts[i][0]}) + "\n")
    gts_t = ptb_tokenize(gts)
    gen_t = ptb_tokenize(gen)

    val_bleu, _ = Bleu(4).compute_score(gts_t, gen_t)
    for name, score in zip(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"],
                           val_bleu):
        print(name, score)
    val_rouge, _ = Rouge().compute_score(gts_t, gen_t)
    print("ROUGE_L", val_rouge)
    val_cider, _ = Cider().compute_score(gts_t, gen_t)
    print("CIDEr", val_cider)
    try:
        val_meteor, _ = Meteor().compute_score(gts_t, gen_t)
        print("METEOR", val_meteor)
    except ExternalMetricUnavailable:
        # no meteor-1.5.jar configured: native METEOR (exact+stem stages,
        # jar-identical formulas/parameters — metrics/meteor.py docstring
        # records the resource-level divergences)
        try:
            val_meteor, _ = NativeMeteor().compute_score(gts_t, gen_t)
            print("METEOR(native)", val_meteor)
        except ImportError as err:   # nltk stemmer missing on this host
            print("METEOR unavailable: %s" % err)
    try:
        val_spice, _ = Spice().compute_score(gts_t, gen_t)
        print("SPICE", val_spice)
    except ExternalMetricUnavailable:
        # no spice-1.0.jar configured: native SPICE (exact scoring model,
        # caption-grammar scene-graph parser — metrics/spice.py docstring
        # records the parser-level divergences)
        val_spice, _ = NativeSpice().compute_score(gts_t, gen_t)
        print("SPICE(native)", val_spice)
    return val_cider


if __name__ == "__main__":
    main()
