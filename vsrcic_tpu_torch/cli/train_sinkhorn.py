"""R-level Sinkhorn SSP training CLI — reference coco_scripts/train_sinkhorn.py
/ flickr_scripts/train_sinkhorn_flickr.py equivalent.

    python -m vsrcic_tpu_torch.cli.train_sinkhorn --synthetic --max_steps 3
    python -m vsrcic_tpu_torch.cli.train_sinkhorn --synthetic --platform cpu

Counterpart of `vsrcic_tpu/cli/train_sinkhorn.py`, with its flags, output
and checkpoint (`model-sh`, the cfg blob beside the weights). It runs on the
CUDA card unless `--platform cpu` is given; with no card it raises. Each
step's forward normalisation is the Sinkhorn kernel on the card (its plain
version on the CPU). Untrained weights come from a `torch.Generator` seeded
with --seed, which cannot reproduce the JAX CLI's `jax.random` draws: the
two CLIs agree when they start from the same checkpoint (`--start_from`).
"""
from __future__ import annotations

import time

import numpy as np

from vsrcic_tpu_torch.cli.common import (base_parser, build_world,
                                         data_parallel_mesh, resolve_device,
                                         run_data_parallel, seed_all)
from vsrcic_tpu_torch.cli.fields import (make_image_field,
                                         make_sinkhorn_det_field)


def main(argv=None):
    # None sentinels: the reference's two Sinkhorn scripts ship DIFFERENT
    # defaults (coco train_sinkhorn.py: batch 16, lr 1e-4, stop 20;
    # flickr train_sinkhorn_flickr.py:28-30,130: batch 100, lr 1e-3,
    # stop 30) — resolved per --dataset after parsing unless overridden
    p = base_parser(batch_size=None)
    p.add_argument("--learning_rate", default=None, type=float)
    p.add_argument("--learning_rate_decay_every", default=3, type=int)
    p.add_argument("--learning_rate_decay_rate", default=0.6, type=float)
    p.add_argument("--stop_epoch", default=None, type=int)
    p.add_argument("--sinkhorn_len", default=10, type=int)
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--data_parallel", default=0, type=int, metavar="N",
                   help="shard training over N devices (N cards, or N "
                   "processes under --platform cpu; 0 = single device): "
                   "the group / pair axis, padded when it does not divide")
    opt = p.parse_args(argv)
    coco = opt.dataset == "coco"
    if opt.batch_size is None:
        opt.batch_size = 16 if coco else 100
    if opt.learning_rate is None:
        opt.learning_rate = 1e-4 if coco else 1e-3
    if opt.stop_epoch is None:
        opt.stop_epoch = 20 if coco else 30
    return run_data_parallel(_run, opt)


def _run(opt):
    """The CLI on one rank (or alone)."""
    print(opt)
    mesh, _ = data_parallel_mesh(opt.data_parallel, None, opt.platform)
    device = mesh.device if mesh else resolve_device(opt.platform)
    rank0 = mesh is None or mesh.rank == 0
    seed_all(opt.seed)
    from vsrcic_tpu_torch.utils.observability import MetricLogger
    mlog = MetricLogger(opt.log_dir if rank0 else None)

    import torch
    from vsrcic_tpu_torch.core.checkpoint import save_checkpoint
    from vsrcic_tpu_torch.data import DataLoader, DictionaryDataset, RawField
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.train import (SinkhornTrainer, planner_lr,
                                        sinkhorn_pairs_from_grids)

    world = build_world(opt)
    train_ex, _, _ = world.splits

    image_field = make_image_field(world, opt)
    det_field = make_sinkhorn_det_field(world, opt, fix_length=10)

    ds = DictionaryDataset(train_ex, {"image": image_field,
                                      "detection": det_field,
                                      "text": RawField()}, "image")
    loader = DataLoader(ds, batch_size=opt.batch_size,
                        num_workers=opt.nb_workers)

    # --start_from resume (same semantics as train_region_sort; ref
    # train_sinkhorn.py mirrors the region-sort script's restore block).
    # The ckpt's stored cfg (slice dims) wins over the CLI flags.
    step, start_epoch, blob = 0, 0, None
    if opt.start_from:
        import os
        from vsrcic_tpu_torch.core.checkpoint import restore_checkpoint
        path = opt.start_from
        cand = os.path.join(path, "model-sh")   # dir form, like the ref
        if mesh is not None:   # no rank reads a checkpoint being written
            from vsrcic_tpu_torch.parallel.mesh import barrier
            barrier(mesh)
        if os.path.isdir(cand) or os.path.isfile(cand + ".npz"):
            path = cand
        blob = restore_checkpoint(path)
        step = int(blob.get("step", 0))
        start_epoch = int(blob.get("epoch", -1)) + 1
        print("resumed Sinkhorn from %s (epoch %d, step %d)"
              % (path, start_epoch - 1, step))

    if blob is not None and "cfg" in blob:
        c = blob["cfg"]
        cfg = SinkhornConfig(n=int(c["n"]), n_iters=int(c["n_iters"]),
                             tau=float(c["tau"]), txt_dim=int(c["txt_dim"]),
                             vis_dim=int(c["vis_dim"]),
                             pos_dim=int(c["pos_dim"]))
    else:
        cfg = SinkhornConfig(n=opt.sinkhorn_len, n_iters=20, tau=0.1,
                             vis_dim=opt.feat_dim)
    params = (blob["params"] if blob is not None
              else init_sinkhorn_params(
                  torch.Generator().manual_seed(opt.seed), cfg))

    norm = "images" if opt.dataset == "coco" else "pairs"
    if mesh is not None:
        from vsrcic_tpu_torch.parallel.mesh import replicate
        params = replicate(params, mesh)
    trainer = SinkhornTrainer(cfg, params, lr=opt.learning_rate,
                              loss_normalization=norm, device=device,
                              mesh=mesh)

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
            n_images = len(det_vals)
            txt = [[o[0] for o in img] for img in det_vals]
            vis = [[o[1] for o in img] for img in det_vals]
            pos = [[o[2] for o in img] for img in det_vals]
            sv = [[o[4] for o in img] for img in det_vals]
            ssr = [[o[5] for o in img] for img in det_vals]
            cv = [[o[6] for o in img] for img in det_vals]
            il = [[o[9] for o in img] for img in det_vals]
            pairs = sinkhorn_pairs_from_grids(
                cv, sv, ssr, il, vis, txt, pos,
                sinkhorn_len=opt.sinkhorn_len)
            if pairs is None:
                continue
            inputs, tr_locs, gt_locs = pairs
            # a float: the loss is on the host before its record is written
            loss = trainer.step(inputs, tr_locs, gt_locs, n_images=n_images)
            running += loss
            mlog.add_scalar('train_loss', loss, step)
            n_it += 1
            step += 1
            if opt.max_steps and step >= opt.max_steps:
                break
        print("epoch %d sinkhorn loss %.4f (%.1fs)"
              % (e, running / max(n_it, 1), time.time() - t0))
        if rank0:
            save_checkpoint(opt.checkpoint_path + "/%s_sinkhorn/model-sh"
                            % opt.dataset,
                            {"params": trainer.state.params,
                             "step": np.asarray(step), "epoch": np.asarray(e),
                             "cfg": {"n": np.asarray(cfg.n),
                                     "n_iters": np.asarray(cfg.n_iters),
                                     "tau": np.asarray(cfg.tau),
                                     "txt_dim": np.asarray(cfg.txt_dim),
                                     "vis_dim": np.asarray(cfg.vis_dim),
                                     "pos_dim": np.asarray(cfg.pos_dim)}})
        if opt.max_steps and step >= opt.max_steps:
            break
    mlog.close()
    print("done.")


if __name__ == "__main__":
    main()
