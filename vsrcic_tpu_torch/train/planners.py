"""Trainers for the two SSP planners (S-level sorter, R-level Sinkhorn).

Counterpart of `vsrcic_tpu/train/planners.py`.

S-SSP (ref coco_scripts/train_region_sort.py): per-batch (verb, det_sr,
gt_sr) groups, extracted on the host by `pipelines.sr_groups` instead of
the reference's inline Python grid scan, fed to the label-smoothed KL loss
(`models.s_ssp.ssp_forward_loss`); Adam, with the scripts' manual
0.6^((e-3)//3+1) decay through `set_lr` (`train.common.planner_lr`).
Dropout draws from a `torch.Generator` on the trainer's device, so its
masks follow JAX's law, not its bits.

Sinkhorn (ref coco_scripts/train_sinkhorn.py): for every (verb, SR) with
more than one region, MSE(tr_locs @ P_soft, gt_locs) where gt comes from
the idx_list permutation; all pairs of a batch run as one batched call. The
normalization's forward is the CUDA kernel on the card and its backward
the plain version replayed (`ops/sinkhorn.py::SinkhornNormalize`).

Entry points run on the CUDA card unless `device` names another; a missing
card raises.

Data parallelism (`mesh`, a `parallel.mesh.DataMesh`; JAX's GSPMD mesh):
the steps take the whole batch on every rank; each rank runs its block of
the batch zero-padded to a multiple of the size, and the gradients are
summed before Adam (`train.common.apply_grads`). Group and pair counts are
data-dependent, so the padding is made inert as in JAX: S-SSP's padded rows
weigh 0 and its denominator, the scored positions, is counted over the
whole batch; Sinkhorn's padded pairs have tr_locs and gt_locs 0 (an error
of exactly 0) and its denominator is explicit. Each rank reports the
global loss. S-SSP's dropout takes the rows of its block from the masks
the whole batch would draw (`core.nn.BlockRNG`), so its steps are those of
the single-device run.
"""
from __future__ import annotations

import numpy as np
import torch

from vsrcic_tpu_torch.core.nn import BlockRNG
from vsrcic_tpu_torch.models.s_ssp import SSPConfig, ssp_forward_loss
from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                              sinkhorn_net_apply)
from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize_grad
from vsrcic_tpu_torch.pipelines.sr_groups import extract_verb_groups
from vsrcic_tpu_torch.parallel.mesh import (all_reduce_sum, block_of,
                                            mesh_device)
from vsrcic_tpu_torch.train.common import (
    TrainState, adam, apply_grads, init_train_state, set_learning_rate,
    value_and_grad)
from vsrcic_tpu_torch.utils.device import as_tensor, to_device


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SSPTrainer:
    def __init__(self, cfg: SSPConfig, params, lr: float = 1e-4, mesh=None,
                 device=None):
        """params: nested dict of tensors or arrays in torch layout (the
        same on every rank under a mesh: `parallel.mesh.replicate`)."""
        self.mesh = mesh
        self.cfg = cfg
        self.device = mesh_device(mesh, device)
        self.tx = adam(lr)
        self.state = init_train_state(to_device(params, self.device),
                                      self.tx)

    def set_lr(self, lr: float):
        self.state = TrainState(self.state.params,
                                set_learning_rate(self.state.opt_state, lr),
                                self.state.step)

    @staticmethod
    def batch_from_grids(control_verb, det_seqs_v, det_seqs_sr, gt_seqs_v,
                         gt_seqs_sr):
        """Nested per-image / per-caption grids -> stacked planner batch
        (verbs (N, 1), det_sr (N, L), gt_sr (N, L)), or None without groups.

        Replaces the reference's in-loop tensor concatenation
        (train_region_sort.py:134-179); takes the DictionaryDataset values
        layout (list per image of list per caption of grids)."""
        verbs, det_list, gt_list = [], [], []
        for img_cv, img_v, img_sr, img_gv, img_gsr in zip(
                control_verb, det_seqs_v, det_seqs_sr, gt_seqs_v, gt_seqs_sr):
            for cv, v, sr, gv, gsr in zip(img_cv, img_v, img_sr, img_gv,
                                          img_gsr):
                for g in extract_verb_groups(cv, v, sr, gv, gsr):
                    verbs.append([g.verb])
                    det_list.append(g.det_sr_seq)
                    gt_list.append(g.gt_sr_seq)
        if not verbs:
            return None
        return (np.asarray(verbs), np.stack(det_list), np.stack(gt_list))

    def loss_and_grads(self, verbs, det_sr, gt_sr, rng=None):
        """(loss, grads) at the current params, with no update; rng: a
        torch.Generator on the trainer's device for dropout, or None.
        Under a mesh: this rank's share of the loss and its gradients."""
        dev, mesh = self.device, self.mesh
        kw = {}
        if mesh is not None:
            gt = _host(gt_sr)
            kw["denom"] = torch.full((), float(len(gt) + (gt != 0).sum()),
                                     device=dev)
            kw["row_weights"] = as_tensor(block_of(
                np.ones(len(gt), np.float32), mesh), dev)
            if rng is not None:
                rng = BlockRNG(rng, *mesh.bounds(len(gt)), len(gt))
            verbs, det_sr, gt_sr = (block_of(_host(x), mesh)
                                    for x in (verbs, det_sr, gt))
        return value_and_grad(
            ssp_forward_loss, self.state.params, self.cfg,
            as_tensor(verbs, dev), as_tensor(det_sr, dev, torch.int32),
            as_tensor(gt_sr, dev, torch.int32), rng=rng, **kw)

    def step(self, verbs, det_sr, gt_sr, rng) -> float:
        """One Adam step; returns the (global) loss."""
        loss, grads = self.loss_and_grads(verbs, det_sr, gt_sr, rng)
        self.state = apply_grads(self.tx, self.state, grads, self.mesh)
        if self.mesh is not None:
            loss = all_reduce_sum(loss, self.mesh)
        return float(loss)


def sinkhorn_pairs_from_grids(control_verb, det_seqs_v, det_seqs_sr,
                              idx_list, seqs_vis, seqs_txt, seqs_pos,
                              sinkhorn_len: int = 10):
    """Build (inputs (N, L, 2352), tr_locs (N, L), gt_locs (N, L)) training
    pairs for every (verb, SR) needing re-ranking (ref train_sinkhorn.py
    :144-205), locations padded with 10.0. Nested DictionaryDataset values
    layout accepted; None without pairs."""
    inputs, tr_all, gt_all = [], [], []
    for img in zip(control_verb, det_seqs_v, det_seqs_sr, idx_list, seqs_vis,
                   seqs_txt, seqs_pos):
        for cv, v, sr, il, vis, txt, pos in zip(*img):
            perm_feats = np.concatenate([vis, txt, pos], -1)
            il = np.asarray(il).squeeze(-1)
            for g in extract_verb_groups(cv, v, sr):
                for sr_val in g.need_re_rank:
                    locs = g.sr_find[sr_val]
                    x = np.zeros((sinkhorn_len, perm_feats.shape[-1]),
                                 np.float32)
                    tr_locs = np.full(sinkhorn_len, 10.0, np.float32)
                    gt_locs = np.full(sinkhorn_len, 10.0, np.float32)
                    for j, loc in enumerate(locs):
                        if j >= sinkhorn_len:
                            continue
                        tr_locs[j] = loc
                        gt_locs[j] = il[loc]
                        x[j] = perm_feats[loc]
                    # target: rank positions in idx_list order (ref :198-205)
                    change = np.argsort(gt_locs)
                    gt_locs_ = np.full(sinkhorn_len, 10.0, np.float32)
                    for j in range(sinkhorn_len):
                        if j < len(locs):
                            gt_locs_[j] = change[j]
                    inputs.append(x)
                    tr_all.append(tr_locs)
                    gt_all.append(gt_locs_)
    if not inputs:
        return None
    return np.stack(inputs), np.stack(tr_all), np.stack(gt_all)


def sinkhorn_loss_fn(params, cfg: SinkhornConfig, inputs, tr_locs, gt_locs,
                     denom, normalize=sinkhorn_normalize_grad):
    """sum over pairs of mean((tr_locs @ P_soft - gt_locs)^2) / denom.
    denom: a 0-d f32 tensor (a division by a tensor, as JAX divides);
    normalize: as `sinkhorn_net_apply` takes it."""
    P = sinkhorn_net_apply(params, cfg, inputs, normalize=normalize)
    resort = torch.einsum("nl,nlm->nm", tr_locs, P)
    per_pair = torch.mean((resort - gt_locs) ** 2, -1)
    return torch.sum(per_pair) / denom


class SinkhornTrainer:
    def __init__(self, cfg: SinkhornConfig, params, lr: float = 1e-4,
                 loss_normalization: str = "images", mesh=None, device=None):
        """loss_normalization: 'images' (COCO script: / batch_size,
        train_sinkhorn.py:211) or 'pairs' (Flickr script: / pair count,
        train_sinkhorn_flickr.py:209-210). mesh: a DataMesh (see the
        module's docstring)."""
        if loss_normalization not in ("images", "pairs"):
            raise ValueError("loss_normalization must be 'images' or 'pairs'")
        self.cfg = cfg
        self.loss_normalization = loss_normalization
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.tx = adam(lr)
        self.state = init_train_state(to_device(params, self.device),
                                      self.tx)

    def set_lr(self, lr: float):
        self.state = TrainState(self.state.params,
                                set_learning_rate(self.state.opt_state, lr),
                                self.state.step)

    def batch(self, inputs, tr_locs, gt_locs, n_images: int):
        """(inputs, tr_locs, gt_locs, denom) as f32 tensors on the
        trainer's device; under a mesh this rank's zero-padded block of the
        pairs, with the whole batch's denom."""
        dev = self.device
        denom = float(n_images if self.loss_normalization == "images"
                      else len(inputs))
        if self.mesh is not None:
            inputs, tr_locs, gt_locs = (block_of(x, self.mesh)
                                        for x in (inputs, tr_locs, gt_locs))
        return (as_tensor(inputs, dev, torch.float32),
                as_tensor(tr_locs, dev, torch.float32),
                as_tensor(gt_locs, dev, torch.float32),
                torch.full((), denom, dtype=torch.float32, device=dev))

    def loss_and_grads(self, inputs, tr_locs, gt_locs, n_images: int,
                       normalize=sinkhorn_normalize_grad):
        """(loss, grads) at the current params, with no update."""
        return value_and_grad(sinkhorn_loss_fn, self.state.params, self.cfg,
                              *self.batch(inputs, tr_locs, gt_locs, n_images),
                              normalize=normalize)

    def step(self, inputs, tr_locs, gt_locs, n_images: int) -> float:
        """One Adam step; returns the (global) loss."""
        loss, grads = self.loss_and_grads(inputs, tr_locs, gt_locs, n_images)
        self.state = apply_grads(self.tx, self.state, grads, self.mesh)
        if self.mesh is not None:
            loss = all_reduce_sum(loss, self.mesh)
        return float(loss)
