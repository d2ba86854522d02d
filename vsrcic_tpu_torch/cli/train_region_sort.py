"""S-level SSP training CLI — reference coco_scripts/train_region_sort.py /
flickr_scripts/train_region_sort_flickr.py equivalent.

    python -m vsrcic_tpu_torch.cli.train_region_sort --synthetic --max_steps 3
    python -m vsrcic_tpu_torch.cli.train_region_sort --synthetic --platform cpu

Counterpart of `vsrcic_tpu/cli/train_region_sort.py`, with its flags, output
and checkpoint (`model-tr`, the cfg blob beside the weights). It runs on the
CUDA card unless `--platform cpu` is given; with no card it raises. No
hand-written kernel runs here, as in JAX. Randomness comes from
`torch.Generator`s keyed by the integers the JAX CLI keys `jax.random`
with: --seed for the untrained weights (on the CPU), the step number for
each step's dropout (on the run's device), so a resumed run replays the
port's own stream; the draws are not JAX's, and the two CLIs agree on
what they feed the trainer, not on its dropout masks.
"""
from __future__ import annotations

import time

import numpy as np

from vsrcic_tpu_torch.cli.common import (base_parser, build_world,
                                         data_parallel_mesh, resolve_device,
                                         seed_all)
from vsrcic_tpu_torch.cli.fields import make_image_field, make_ssp_det_field


def main(argv=None):
    p = base_parser(batch_size=20)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--learning_rate_decay_every", default=3, type=int)
    p.add_argument("--learning_rate_decay_rate", default=0.6, type=float)
    p.add_argument("--stop_epoch", default=20, type=int)
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--data_parallel", default=0, type=int, metavar="N",
                   help="shard training over N devices (not ported yet: "
                   "only 0, a single device)")
    # planner width knobs (the reference hardcodes 512/512/3,
    # sort_model.py:23-28 — defaults match; tiny values make the CLI
    # testable on a CPU host, like the captioner's dim flags)
    p.add_argument("--ssp_hidden_size", default=512, type=int)
    p.add_argument("--ssp_embed_size", default=512, type=int)
    p.add_argument("--ssp_layers", default=3, type=int)
    opt = p.parse_args(argv)
    print(opt)
    device = resolve_device(opt.platform)
    data_parallel_mesh(opt.data_parallel, None)   # raises unless 0
    seed_all(opt.seed)
    from vsrcic_tpu_torch.utils.observability import MetricLogger
    mlog = MetricLogger(opt.log_dir)

    import torch
    from vsrcic_tpu_torch.core.checkpoint import save_checkpoint
    from vsrcic_tpu_torch.data import DataLoader, DictionaryDataset, RawField
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.train import SSPTrainer, planner_lr

    world = build_world(opt)
    train_ex, _, _ = world.splits

    image_field = make_image_field(world, opt)
    det_field = make_ssp_det_field(world, opt, fix_length=10)

    ds = DictionaryDataset(train_ex, {"image": image_field,
                                      "detection": det_field,
                                      "text": RawField()}, "image")
    loader = DataLoader(ds, batch_size=opt.batch_size,
                        num_workers=opt.nb_workers)

    # --start_from resume (ref train_region_sort.py:96-109 restores
    # model + infos{epoch, iter}; its model-best branch is dead code —
    # nothing in the script ever writes model-best.pth — so --load_best
    # resolves to the same single saved file here). The ckpt's stored cfg
    # wins over the CLI dim flags (a width mismatch would load cleanly
    # and compute silently wrong activations — sqrt(embed) scaling).
    step, start_epoch, blob = 0, 0, None
    if opt.start_from:
        import os
        from vsrcic_tpu_torch.core.checkpoint import restore_checkpoint
        path = opt.start_from
        cand = os.path.join(path, "model-tr")   # dir form, like the ref
        if os.path.isdir(cand) or os.path.isfile(cand + ".npz"):
            path = cand
        blob = restore_checkpoint(path)
        step = int(blob.get("step", 0))
        start_epoch = int(blob.get("epoch", -1)) + 1
        print("resumed S-SSP from %s (epoch %d, step %d)"
              % (path, start_epoch - 1, step))

    if blob is not None and "cfg" in blob:
        c = blob["cfg"]
        ds = ("coco" if int(c["dataset_id"]) == 0 else "flickr") \
            if "dataset_id" in c else opt.dataset
        cfg = SSPConfig(dataset=ds,
                        hidden_size=int(c["hidden_size"]),
                        embed_size=int(c["embed_size"]),
                        encoder_layers=int(c["encoder_layers"]),
                        decoder_layers=int(c["decoder_layers"]),
                        max_len=int(c.get("max_len", 10)))
    else:
        cfg = SSPConfig(dataset=opt.dataset,
                        hidden_size=opt.ssp_hidden_size,
                        embed_size=opt.ssp_embed_size,
                        encoder_layers=opt.ssp_layers,
                        decoder_layers=opt.ssp_layers)
    params = (blob["params"] if blob is not None
              else init_ssp_params(torch.Generator().manual_seed(opt.seed),
                                   cfg))

    trainer = SSPTrainer(cfg, params, lr=opt.learning_rate, device=device)

    for e in range(start_epoch, opt.max_epochs):
        if e == opt.stop_epoch:
            break
        trainer.set_lr(planner_lr(opt.learning_rate, e,
                                  opt.learning_rate_decay_every,
                                  opt.learning_rate_decay_rate))
        running, n_it = 0.0, 0
        t0 = time.time()
        for keys, values in loader:
            det_vals = values["detection"]
            if opt.dataset == "flickr":   # visual=False: 7 outputs
                idx = {"v": 0, "sr": 1, "cv": 2, "gv": 3, "gsr": 4}
            else:                          # 11 outputs
                idx = {"v": 4, "sr": 5, "cv": 6, "gv": 7, "gsr": 8}
            cv = [[o[idx["cv"]] for o in img] for img in det_vals]
            sv = [[o[idx["v"]] for o in img] for img in det_vals]
            ssr = [[o[idx["sr"]] for o in img] for img in det_vals]
            gv = [[o[idx["gv"]] for o in img] for img in det_vals]
            gsr = [[o[idx["gsr"]] for o in img] for img in det_vals]
            batch = SSPTrainer.batch_from_grids(cv, sv, ssr, gv, gsr)
            if batch is None:
                continue
            verbs, det_sr, gt_sr = batch
            # dropout keyed by the step, as JAX keys PRNGKey(step)
            loss = trainer.step(verbs, det_sr, gt_sr, torch.Generator(
                device=device).manual_seed(step))
            running += loss
            mlog.add_scalar('train_loss', loss, step)
            n_it += 1
            step += 1
            if opt.max_steps and step >= opt.max_steps:
                break
        print("epoch %d s-ssp loss %.4f (%.1fs)"
              % (e, running / max(n_it, 1), time.time() - t0))
        # cfg travels with the weights: reduced-width planners would
        # otherwise load under the default 512/512/3 SSPConfig WITHOUT a
        # shape error (sqrt(embed_size) scaling, layer count) and compute
        # silently wrong plans at eval/resume
        save_checkpoint(opt.checkpoint_path + "/%s_s_ssp/model-tr"
                        % opt.dataset,
                        {"params": trainer.state.params,
                         "step": np.asarray(step), "epoch": np.asarray(e),
                         "cfg": {"dataset_id": np.asarray(
                                     0 if opt.dataset == "coco" else 1),
                                 "hidden_size": np.asarray(cfg.hidden_size),
                                 "embed_size": np.asarray(cfg.embed_size),
                                 "encoder_layers":
                                     np.asarray(cfg.encoder_layers),
                                 "decoder_layers":
                                     np.asarray(cfg.decoder_layers),
                                 "max_len": np.asarray(cfg.max_len)}})
        if opt.max_steps and step >= opt.max_steps:
            break
    mlog.close()
    print("done.")


if __name__ == "__main__":
    main()
