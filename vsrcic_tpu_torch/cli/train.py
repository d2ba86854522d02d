"""Captioner training CLI (XE + SCST RL) — reference coco_scripts/train.py
equivalent with matched flags.

    python -m vsrcic_tpu_torch.cli.train --synthetic --batch_size 8 --max_steps 3
    python -m vsrcic_tpu_torch.cli.train --sample_rl --fast_decode ...
    python -m vsrcic_tpu_torch.cli.train --synthetic --platform cpu ...

Counterpart of `vsrcic_tpu/cli/train.py`, with its flags, output and
checkpoints (`CheckpointManager`'s best/last files and meta, the cfg blob
beside the weights): each package resumes the other's. It runs on the CUDA
card unless `--platform cpu` is given; with no card it raises.
`--sample_rl --fast_decode` decodes through the fused attention kernel on
bf16 tables built from the live params each step (its plain version on the
CPU). Randomness comes from `torch.Generator`s keyed by the integers the
JAX CLI keys `jax.random` with: --seed for the untrained weights (on the
CPU), the step number for each SCST step's samples (on the run's device),
so a resumed run replays the port's own stream. The draws are not JAX's:
the two CLIs agree when they start from the same checkpoint
(`--start_from`, or the XE checkpoint an SCST run restores).

Each training batch is staged on the device by the loader's producer
thread (`DevicePrefetchLoader` with `cuda_put`), on the device's default
stream, which the steps run on: a step starts after its batch's copies.
"""
from __future__ import annotations

import functools
import time

import numpy as np

from vsrcic_tpu_torch.cli.common import (base_parser, build_world,
                                         data_parallel_mesh, resolve_device,
                                         seed_all)


def main(argv=None):
    p = base_parser(batch_size=100)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--step_size", default=3, type=int)
    p.add_argument("--gamma", default=0.8, type=float)
    p.add_argument("--h2_first_lstm", default=1, type=int)
    p.add_argument("--img_second_lstm", default=0, type=int)
    p.add_argument("--sample_rl", action="store_true")
    p.add_argument("--scst_baseline", default="step",
                   choices=("step", "epoch"),
                   help="SCST baseline: 'step' = live-params greedy decode "
                   "sharing the sample decode's statics; 'epoch' = the "
                   "reference scheme (frozen epoch-start greedy pass, "
                   "ref train.py:122-138)")
    p.add_argument("--patience", default=5, type=int)
    p.add_argument("--fast_decode", action="store_true",
                   help="SCST sample/greedy decodes through the fused "
                   "attention CUDA kernel on bf16 tables; gradient "
                   "logprobs stay strict")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--data_parallel", default=0, type=int, metavar="N",
                   help="shard training over N devices (not ported yet: "
                   "only 0, a single device)")
    opt = p.parse_args(argv)
    # --dataset flickr is an EXTENSION: the reference ships no Flickr
    # captioner-training script (SURVEY.md S7; its flickr checkpoint is
    # pretrained) — here the same XE/SCST trainers run on Flickr entities
    # via FlickrControlSequenceField (entity-IoU region groups)
    print(opt)
    device = resolve_device(opt.platform)
    data_parallel_mesh(opt.data_parallel, None)   # raises unless 0
    seed_all(opt.seed)
    from vsrcic_tpu_torch.utils.observability import MetricLogger
    mlog = MetricLogger(opt.log_dir)

    import torch
    from vsrcic_tpu_torch.core.checkpoint import CheckpointManager
    from vsrcic_tpu_torch.data import (COCOControlSequenceField, DataLoader,
                                       DevicePrefetchLoader,
                                       FlickrControlSequenceField,
                                       FlickrDetectionField,
                                       ImageDetectionsField, PairedDataset,
                                       RawField)
    from vsrcic_tpu_torch.data.loader import cuda_put
    from vsrcic_tpu_torch.decode.loops import (expand_compact_groups,
                                               greedy_decode)
    from vsrcic_tpu_torch.metrics import (Bleu, Cider,
                                          ExternalMetricUnavailable, Meteor,
                                          NativeMeteor, Rouge)
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params,
                                                   precompute_statics)
    from vsrcic_tpu_torch.text import dedup_join, ptb_tokenize
    from vsrcic_tpu_torch.train import (CaptionerSCSTTrainer,
                                        CaptionerXETrainer, step_lr)
    from vsrcic_tpu_torch.utils.device import as_tensor

    world = build_world(opt)
    tf = world.text_field
    train_ex, val_ex, _ = world.splits

    img_max_det = 100
    if opt.dataset == "flickr":
        # diverse=True so the field returns (features, image_id) like the
        # COCO ImageDetectionsField (the loop unpacks both)
        image_field = FlickrDetectionField(world.store, diverse=True,
                                           max_detections=img_max_det)
        det_field = FlickrControlSequenceField(
            world.store, padding_idx=-1, fix_length=20, compact=True,
            image_max_detections=img_max_det)
    else:
        image_field = ImageDetectionsField(world.store,
                                           max_detections=img_max_det)
        det_field = COCOControlSequenceField(
            world.store, classes_path=world.classes, padding_idx=-1,
            all_boxes=False, fix_length=20, compact=True,
            image_max_detections=img_max_det)

    train_ds = PairedDataset(train_ex, {"image": image_field,
                                        "detection": det_field,
                                        "text": RawField()})
    val_ds = PairedDataset(val_ex, {"image": image_field,
                                    "detection": det_field,
                                    "text": RawField()})
    raw_train = DataLoader(train_ds, batch_size=opt.batch_size,
                           shuffle=not opt.sample_rl, seed=opt.seed,
                           num_workers=opt.nb_workers)
    # the producer thread stages each batch's arrays: batch k+1's
    # asynchronous host->device copies ride under batch k's step instead
    # of serializing in front of it
    loader_train = DevicePrefetchLoader(
        raw_train, functools.partial(cuda_put, device=device), depth=2)
    loader_val = DataLoader(val_ds, batch_size=min(16, opt.batch_size))

    cfg = CaptionerConfig(seq_len=20, vocab_size=len(tf.vocab),
                          bos_idx=tf.bos_idx,
                          det_feat_size=opt.feat_dim,
                          input_encoding_size=opt.input_encoding_size,
                          rnn_size=opt.rnn_size, att_size=opt.att_size,
                          h2_first_lstm=bool(opt.h2_first_lstm),
                          img_second_lstm=bool(opt.img_second_lstm))
    params = init_captioner_params(torch.Generator().manual_seed(opt.seed),
                                   cfg)

    cap_dir = "/%s_cap" % opt.dataset   # matches ref ckpt layout (eval_*.py:39)
    ckpt = CheckpointManager(opt.checkpoint_path + cap_dir,
                             opt.exp_name + ("_rl" if opt.sample_rl else ""))
    restored = None
    if opt.sample_rl:
        # RL warm-starts from the XE best checkpoint (ref train.py:85-90)
        xe_ckpt = CheckpointManager(opt.checkpoint_path + cap_dir,
                                    opt.exp_name)
        restored = xe_ckpt.restore(best=True)
        if restored is not None:
            print("restored XE best (val CIDEr %.3f)"
                  % xe_ckpt.meta.get("best_metric", float("nan")))
    elif opt.start_from:
        restored = ckpt.restore(best=opt.load_best)
        if restored is not None:
            print("restored checkpoint (best_metric=%.3f)"
                  % ckpt.meta.get("best_metric", float("nan")))
    if restored is not None:
        if "cfg" in restored:
            ckpt_vocab = int(restored["cfg"]["vocab_size"])
            if ckpt_vocab != len(tf.vocab):
                # same guard as cli/eval.py: a vocab mismatch surfaces much
                # later as an opaque shape error (or silently wrong decode)
                raise SystemExit(
                    "checkpoint vocab_size %d != world vocab %d — the "
                    "checkpoint was trained against a different vocabulary"
                    % (ckpt_vocab, len(tf.vocab)))
        params = restored["params"]

    if opt.sample_rl:
        ref_caps = [e.text for e in train_ex]
        ref_tok = ptb_tokenize({i: [c] for i, c in enumerate(ref_caps)})
        cider_train = Cider(gts=ref_tok)
        from vsrcic_tpu_torch.metrics.cider_native import maybe_native
        native_cider = maybe_native(cider_train)
        trainer = CaptionerSCSTTrainer(
            cfg, params, tf, cider_train, lr=opt.lr,
            baseline=opt.scst_baseline, fast_decode=opt.fast_decode,
            table_dtype=torch.bfloat16 if opt.fast_decode else None,
            native_cider=native_cider, device=device)
    else:
        trainer = CaptionerXETrainer(cfg, params, lr=opt.lr, device=device)

    cider_val = Cider()

    @torch.no_grad()
    def val_decode(params, dets, ids_test):
        groups = expand_compact_groups(dets, ids_test)
        statics = precompute_statics(params, cfg, dets, groups)
        return greedy_decode(params, cfg, statics)

    step = 0
    for e in range(opt.max_epochs):
        if not opt.sample_rl:
            trainer.set_lr(step_lr(opt.lr, e, opt.step_size, opt.gamma))
        t0 = time.time()
        epoch_baselines = None
        if opt.sample_rl and opt.scst_baseline == "epoch":
            # frozen epoch-start greedy baseline pass (ref train.py:122-138);
            # loader order is deterministic in RL mode (shuffle off), so
            # per-batch snapshots pair with the same batches below
            epoch_baselines = []
            for batch in loader_train:
                (dets, _), det_out, _ = batch
                _, _, det_seqs_test, _ = det_out
                epoch_baselines.append(trainer.epoch_baseline_caps(
                    dets, expand_compact_groups(dets, det_seqs_test)))
        running = 0.0
        n_it = 0
        for batch in loader_train:
            (dets, _), det_out, caps = batch
            det_seqs, gate_gts, det_seqs_test, _ = det_out
            # each step returns floats: the loss is on the host before its
            # record is written
            if opt.sample_rl:
                base = (epoch_baselines[n_it]
                        if epoch_baselines is not None else None)
                loss, adv = trainer.step(
                    dets, expand_compact_groups(dets, det_seqs_test),
                    list(caps),
                    torch.Generator(device=device).manual_seed(step),
                    baseline_caps=base)
            else:
                cap_ids = tf.process(list(caps))
                loss, lc, lg = trainer.step(dets, cap_ids, det_seqs,
                                            gate_gts)
            running += loss
            mlog.add_scalar('train_loss', loss, step)
            n_it += 1
            step += 1
            if opt.max_steps and step >= opt.max_steps:
                break
        print("epoch %d train loss %.4f (%.1fs)"
              % (e, running / max(n_it, 1), time.time() - t0))

        # validation CIDEr with greedy decode (ref train.py:185-219)
        gen, gts = {}, {}
        i = 0
        for batch in loader_val:
            (dets, _), det_out, caps = batch
            _, _, det_seqs_test, _ = det_out
            words, _ = val_decode(trainer.state.params,
                                  as_tensor(dets, device),
                                  as_tensor(det_seqs_test, device))
            for w, c in zip(words.cpu().numpy(), caps):
                gen[i] = [dedup_join(tf.decode(w, join_words=False))]
                gts[i] = [c]
                i += 1
        # the reference prints the full metric table each validation
        # epoch (train.py:207-219: Bleu_1..4, METEOR, ROUGE_L, CIDEr);
        # best-ckpt selection stays on CIDEr (train.py:237-243)
        gts_t, gen_t = ptb_tokenize(gts), ptb_tokenize(gen)
        val_bleu, _ = Bleu(4).compute_score(gts_t, gen_t)
        for name, score in zip(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"],
                               val_bleu):
            print(name, score)
        try:
            val_meteor, _ = Meteor().compute_score(gts_t, gen_t)
            print("METEOR", val_meteor)
        except ExternalMetricUnavailable:
            try:
                val_meteor, _ = NativeMeteor().compute_score(gts_t, gen_t)
                print("METEOR(native)", val_meteor)
            except ImportError as err:   # nltk missing: don't kill training
                print("METEOR unavailable: %s" % err)
        val_rouge, _ = Rouge().compute_score(gts_t, gen_t)
        print("ROUGE_L", val_rouge)
        val_cider, _ = cider_val.compute_score(gts_t, gen_t)
        print("epoch %d val CIDEr %.4f" % (e, val_cider))

        # persist the model hyperparams with the weights so eval can
        # rebuild the model without re-matched CLI flags — the reference
        # stores its argparse `opt` in the ckpt and eval_coco.py:39-40
        # reads it back to reconstruct the captioner
        cfg_blob = {"seq_len": np.asarray(cfg.seq_len),
                    "vocab_size": np.asarray(cfg.vocab_size),
                    "bos_idx": np.asarray(cfg.bos_idx),
                    "det_feat_size": np.asarray(cfg.det_feat_size),
                    "input_encoding_size": np.asarray(cfg.input_encoding_size),
                    "rnn_size": np.asarray(cfg.rnn_size),
                    "att_size": np.asarray(cfg.att_size),
                    "h2_first_lstm": np.asarray(cfg.h2_first_lstm),
                    "img_second_lstm": np.asarray(cfg.img_second_lstm)}
        stop = ckpt.step({"params": trainer.state.params,
                          "step": np.asarray(step), "cfg": cfg_blob},
                         val_cider, e, patience_limit=opt.patience)
        if stop:
            print("patience ended.")
            break
        if opt.max_steps and step >= opt.max_steps:
            break
    mlog.close()
    print("done.")


if __name__ == "__main__":
    main()
