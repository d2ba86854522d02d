"""Captioner trainers: XE and SCST CIDEr RL.

Counterpart of `vsrcic_tpu/train/captioner.py`.

XE (ref coco_scripts/train.py:92-120): NLL(word) + 4 * NLL(gate, ignore -1),
Adam.

SCST (ref train.py:121-183): the sampled decode and the greedy baseline run
on the device under `torch.no_grad()`; rewards are the Python tokenizer and
CIDEr-D on the host, the CIDEr-D part in C++ when a `NativeCiderPair` is
given (`metrics/cider_native.py`); the gradient pass recomputes the
trajectory's logprobs (`decode.loops.forced_feedback_logprobs`) in strict
f32 on the f32 detections and groups:
loss = -(mean word logp + mean gate logp) * (CIDEr(sample) - CIDEr(greedy)).
With `fast_decode` the two decodes go through the fused attention op (the
CUDA kernel on the card) with the fused step weights, on tables of
`table_dtype`; the gradient pass stays strict either way. The fused kernel
takes any number of rows, so the decode batch is not padded.

Entry points run on the CUDA card unless `device` names another; a missing
card raises.

Data parallelism (`mesh`, a `parallel.mesh.DataMesh`; JAX's GSPMD mesh):
each rank takes the gradient of its block's share of the global loss and
the gradients are summed before Adam (`train.common.apply_grads`). XE
takes each rank's block of the batch (`parallel.mesh.shard_batch`), keeps
the global denominators (b * (T - 1) words over every rank's b, the gate
targets counted over every rank) and reports the global losses. SCST takes
the whole batch on every rank, as JAX's step does: the decodes run on the
rank's block of the batch padded to a multiple of the size by repeats of
its last example and are gathered back; the strict sampled decode draws
the whole batch's uniforms on every rank from the caller's generator and
takes its block's (so its trajectories are the single-device run's), the
fast one draws from a generator of the rank's own
(`train.common.rank_generator`); rewards and the mean advantage are
computed over the whole batch on every rank; the gradient pass runs on the
rank's block with padded rows at advantage 0, its mean scaled by
block / batch rows, so the ranks' shares sum to the true mean.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from vsrcic_tpu_torch.core.nn import BlockRNG
from vsrcic_tpu_torch.decode.loops import (
    _take, expand_compact_groups, forced_feedback_logprobs,
    forward_teacher_forcing, greedy_decode, sample_decode)
from vsrcic_tpu_torch.metrics.cider import Cider
from vsrcic_tpu_torch.metrics.cider_native import NativeCiderPair
from vsrcic_tpu_torch.models.api import ControllableCaptioner
from vsrcic_tpu_torch.models.captioner import (
    CaptionerConfig, Statics, captioner_step, image_descriptor_f32,
    init_state, precompute_statics)
from vsrcic_tpu_torch.parallel.mesh import (all_gather_blocks,
                                            all_reduce_sum, block_of,
                                            mesh_device)
from vsrcic_tpu_torch.text.tokenizer import ptb_tokenize
from vsrcic_tpu_torch.text.vocab import TextField, dedup_join
from vsrcic_tpu_torch.train.common import (
    TrainState, adam, apply_grads, init_train_state, nll_loss,
    rank_generator, set_learning_rate, value_and_grad)
from vsrcic_tpu_torch.utils.device import as_tensor, to_device


def xe_loss_fn(params, cfg: CaptionerConfig, detections, captions,
               ctrl_det_seqs, gate_targets, lean: bool = True, mesh=None):
    """ref train.py:103-110: word loss shifted; gate loss unshifted,
    weighted 4x, -1 ignored. Returns (loss, (loss_cap, loss_gate)).

    ctrl_det_seqs: dense (B, T, M, D) float groups or compact (B, T, M) int
    ids. Compact ids take the memory-lean path unless lean=False, which
    expands them once and runs the dense path. Under a mesh the arguments
    are this rank's block and the result its share of the global losses."""
    if not ctrl_det_seqs.is_floating_point():
        if lean:
            return _xe_loss_compact(params, cfg, detections, captions,
                                    ctrl_det_seqs, gate_targets, mesh)
        ctrl_det_seqs = expand_compact_groups(detections, ctrl_det_seqs)
    word_logp, gate_logp = forward_teacher_forcing(
        params, cfg, detections, captions, ctrl_det_seqs)
    loss_cap = nll_loss(word_logp[:, :-1], captions[:, 1:], mesh=mesh)
    loss_gate = nll_loss(gate_logp, gate_targets, ignore_index=-1,
                         mesh=mesh)
    return loss_cap + 4.0 * loss_gate, (loss_cap, loss_gate)


def _xe_loss_compact(params, cfg: CaptionerConfig, detections, captions,
                     det_ids, gate_targets, mesh=None):
    """XE loss from compact (B, T, M) int group ids, memory-lean: each
    step expands its group, projects it and reduces its NLL terms inside a
    checkpointed step, so neither the (B, T, M, D) groups nor the (B, T, V)
    logprobs are kept, and the backward recomputes the step. Equal to the
    dense path (word loss over b * (T - 1) terms, gate loss over the
    targets that are not -1)."""
    b, t_len = captions.shape
    captions = captions.long()
    gate_targets = gate_targets.long()
    statics = Statics(image_descriptor_f32(detections).to(detections.dtype),
                      None, None, None, None)
    # step t predicts captions[:, t + 1]; the last step's word term is
    # masked, as the dense path drops it
    tgt_next = torch.cat([captions[:, 1:], torch.zeros_like(captions[:, :1])],
                         1)

    def body(state, it, ids_t, tgt_t, gate_t, on_t):
        (w_logp, g_logp), state = captioner_step(
            params, cfg, state, statics, it=it,
            det_curr=expand_compact_groups(detections, ids_t))
        g_valid = gate_t != -1
        g_lp = _take(g_logp, gate_t.clamp(0, 1))
        return (state, _take(w_logp, tgt_t).sum() * on_t,
                (g_lp * g_valid).sum(), g_valid.float().sum())

    state = init_state(cfg, b, device=detections.device)
    sums = [], [], []
    for t in range(t_len):
        # the step draws no random numbers: no RNG state to keep
        state, *out = checkpoint(
            body, state, captions[:, t], det_ids[:, t], tgt_next[:, t],
            gate_targets[:, t], 1.0 if t < t_len - 1 else 0.0,
            use_reentrant=False, preserve_rng_state=False)
        for acc, x in zip(sums, out):
            acc.append(x)
    w_sums, g_sums, g_counts = (torch.stack(a) for a in sums)
    g_count = g_counts.sum()
    if mesh is not None:   # the global denominators
        b *= mesh.size
        g_count = all_reduce_sum(g_count, mesh)
    loss_cap = -w_sums.sum() / (b * (t_len - 1))
    loss_gate = -g_sums.sum() / g_count.clamp_min(1.0)
    return loss_cap + 4.0 * loss_gate, (loss_cap, loss_gate)


class CaptionerXETrainer:
    def __init__(self, cfg: CaptionerConfig, params, lr: float = 5e-4,
                 mesh=None, lean: bool = True, device=None):
        """params: nested dict of tensors or arrays in torch layout (the
        same on every rank: `parallel.mesh.replicate`). lean: compact-id
        batches take the checkpointed per-step loss (what batch 1024
        needs); lean=False expands them once. mesh: a DataMesh; the steps
        then take this rank's block (`parallel.mesh.shard_batch`) of a
        batch that divides by its size: a zero-padded row would count in
        the word loss, as in JAX."""
        self.mesh = mesh
        self.cfg = cfg
        self.lean = lean
        self.device = mesh_device(mesh, device)
        self.tx = adam(lr)
        self.state = init_train_state(to_device(params, self.device),
                                      self.tx)

    def set_lr(self, lr: float):
        self.state = TrainState(self.state.params,
                                set_learning_rate(self.state.opt_state, lr),
                                self.state.step)

    def _batch(self, detections, captions, ctrl_det_seqs, gate_targets):
        dev = self.device
        ctrl = as_tensor(ctrl_det_seqs, dev)
        if not ctrl.is_floating_point():
            ctrl = ctrl.long()
        return (as_tensor(detections, dev), as_tensor(captions, dev,
                                                      torch.long),
                ctrl, as_tensor(gate_targets, dev, torch.long))

    def loss_and_grads(self, detections, captions, ctrl_det_seqs,
                       gate_targets):
        """((loss, (loss_cap, loss_gate)), grads) at the current params,
        with no update."""
        return value_and_grad(xe_loss_fn, self.state.params, self.cfg,
                              *self._batch(detections, captions,
                                           ctrl_det_seqs, gate_targets),
                              lean=self.lean, mesh=self.mesh, has_aux=True)

    def step(self, detections, captions, ctrl_det_seqs, gate_targets):
        """One Adam step; returns (loss, loss_cap, loss_gate) as floats
        (under a mesh, the global ones)."""
        (loss, (lc, lg)), grads = self.loss_and_grads(
            detections, captions, ctrl_det_seqs, gate_targets)
        self.state = apply_grads(self.tx, self.state, grads, self.mesh)
        losses = torch.stack([loss, lc, lg])
        if self.mesh is not None:
            losses = all_reduce_sum(losses, self.mesh)
        return tuple(losses.tolist())


def scst_loss_fn(params, cfg: CaptionerConfig, detections, det_groups,
                 words, gates, advantage, remat: bool = False,
                 scale: float = 1.0):
    """The mean over the rows of -(mean word logp + mean gate logp) *
    advantage, times `scale` (a rank's block rows / the batch's rows under
    a mesh; 1.0 multiplies exactly)."""
    statics = precompute_statics(params, cfg, detections, det_groups)
    w_lps, g_lps = forced_feedback_logprobs(params, cfg, statics, words,
                                            gates, remat=remat)
    per_seq = -(w_lps.mean(-1) + g_lps.mean(-1)) * advantage
    return per_seq.mean() * scale


class CaptionerSCSTTrainer:
    """Self-critical sequence training with the CIDEr-D reward.

    Two baseline schemes:
      * ``baseline="step"``: a greedy decode with the live params every
        step, sharing the statics of the sampled decode;
      * ``baseline="epoch"``: the reference scheme (ref train.py:122-138):
        call `epoch_baseline_caps` per batch at epoch start and pass the
        result to `step(..., baseline_caps=...)`.
    """

    def __init__(self, cfg: CaptionerConfig, params, text_field: TextField,
                 cider: Cider, lr: float = 5e-4, mesh=None,
                 baseline: str = "step", fast_decode: bool = False,
                 table_dtype=None, remat: bool = True, native_cider=None,
                 device=None):
        """remat: checkpoint the gradient pass's steps (same gradients, one
        more forward in the backward), what batch 1024 needs.
        fast_decode: decode through the fused attention op and the fused
        step weights, with the tables in table_dtype (e.g. torch.bfloat16).
        native_cider: a NativeCiderPair built from `cider`
        (`metrics.cider_native.maybe_native`): the reward's CIDEr-D in C++,
        equal to the Python scorer's to float64 round-off.
        mesh: a DataMesh (see the module's docstring); the steps take the
        whole batch on every rank.
        """
        if baseline not in ("step", "epoch"):
            raise ValueError("baseline must be 'step' or 'epoch'")
        if native_cider is not None and not isinstance(native_cider,
                                                       NativeCiderPair):
            raise TypeError("native_cider must be a NativeCiderPair, got %s"
                            % type(native_cider).__name__)
        self.native_cider = native_cider
        self.cfg = cfg
        self.text_field = text_field
        self.cider = cider
        self.baseline = baseline
        self.remat = remat
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.tx = adam(lr)
        self.state = init_train_state(to_device(params, self.device),
                                      self.tx)
        self._fast = None
        if fast_decode:
            self._fast = ControllableCaptioner(
                cfg, params=self.state.params, use_fused_attention=True,
                table_dtype=table_dtype, device=self.device)
            # a kernel factory only: every decode passes the live params, so
            # its construction-time params must never be read
            self._fast.params = None
            self._fast.decode_params = None

    def set_lr(self, lr: float):
        self.state = TrainState(self.state.params,
                                set_learning_rate(self.state.opt_state, lr),
                                self.state.step)

    @torch.no_grad()
    def decode(self, detections, det_groups, gen=None, greedy=True):
        """With the live params: the sampled decode ((words, gates),
        (word_logps, gate_logps)) when `gen` (a torch.Generator on the
        trainer's device, or a `core.nn.BlockRNG` over one) is given, else
        None; and the greedy words (B, T) when `greedy`, else None. Both
        share one statics."""
        params = self.state.params
        if self._fast is not None:
            statics, fused, fw = self._fast._fused_statics(
                params, detections, det_groups)
        else:
            statics = precompute_statics(params, self.cfg, detections,
                                         det_groups)
            fused = fw = None
        sampled = None if gen is None else sample_decode(
            params, self.cfg, statics, gen, fused_fn=fused, fused_w=fw)
        base = None if not greedy else greedy_decode(
            params, self.cfg, statics, fused_fn=fused, fused_w=fw)[0]
        return sampled, base

    def _decode_batch(self, detections, det_groups, gen=None, greedy=True):
        """`decode` of the whole batch; under a mesh each rank decodes its
        block of the batch padded by repeats of the last example, and the
        blocks are gathered and cut back to the batch."""
        mesh = self.mesh
        if mesh is None:
            return self.decode(detections, det_groups, gen, greedy)
        b = detections.shape[0]
        if gen is not None:
            # strict: this block's rows of the whole batch's draws; fast:
            # the rank's own stream
            gen = (rank_generator(gen, mesh) if self._fast is not None
                   else BlockRNG(gen, *mesh.bounds(b), b))
        sampled, base = self.decode(block_of(detections, mesh, fill=None),
                                    block_of(det_groups, mesh, fill=None),
                                    gen, greedy)

        def whole(x):
            return all_gather_blocks(x, mesh)[:b]

        if sampled is not None:
            sampled = tuple(tuple(whole(x) for x in part) for part in sampled)
        return sampled, None if base is None else whole(base)

    def _decode_caps(self, words) -> List[str]:
        caps = self.text_field.decode(words.cpu().numpy(), join_words=False)
        return [dedup_join(c) for c in caps]

    def _inputs(self, detections, det_groups):
        return (as_tensor(detections, self.device),
                as_tensor(det_groups, self.device))

    def epoch_baseline_caps(self, detections, det_groups) -> List[str]:
        """Greedy baseline captions for one batch with the current (epoch-
        start) params (ref train.py:122-138)."""
        _, base = self._decode_batch(*self._inputs(detections, det_groups))
        return self._decode_caps(base)

    def rewards(self, sampled_caps: List[str], baseline_caps: List[str],
                gt_caps: List[str]) -> np.ndarray:
        """CIDEr-D(sample) - CIDEr-D(baseline) per caption, f32; one
        reference cook for both, in C++ when the trainer has native_cider."""
        gts = ptb_tokenize({i: [g] for i, g in enumerate(gt_caps)})
        gen = ptb_tokenize({i: [c] for i, c in enumerate(sampled_caps)})
        base = ptb_tokenize({i: [c] for i, c in enumerate(baseline_caps)})
        if self.native_cider is not None:
            keys = range(len(gt_caps))
            r, rb = self.native_cider.score_pair(
                [gts[i][0] for i in keys], [gen[i][0] for i in keys],
                [base[i][0] for i in keys])
        else:
            r, rb = self.cider.compute_score_pair(gts, gen, base)
        return (r - rb).astype(np.float32)

    def grad_step(self, detections, det_groups, words, gates,
                  advantage) -> float:
        """One Adam step on scst_loss_fn for given trajectories and
        advantages (B,) of the whole batch; returns the loss. Under a mesh
        each rank steps on its block: padded rows repeat the last and
        have advantage 0."""
        dev, mesh = self.device, self.mesh
        adv = np.asarray(advantage, np.float32)
        args = [as_tensor(detections, dev), as_tensor(det_groups, dev),
                as_tensor(words, dev, torch.long),
                as_tensor(gates, dev, torch.long)]
        scale = 1.0
        if mesh is not None:
            lo, hi = mesh.bounds(len(adv))
            scale = (hi - lo) / len(adv)
            args = [block_of(a, mesh, fill=None) for a in args]
            adv = block_of(adv, mesh)
        loss, grads = value_and_grad(
            scst_loss_fn, self.state.params, self.cfg, *args,
            as_tensor(adv, dev), remat=self.remat, scale=scale)
        self.state = apply_grads(self.tx, self.state, grads, mesh)
        if mesh is not None:
            loss = all_reduce_sum(loss, mesh)
        return float(loss)

    def step(self, detections, det_groups, gt_caps: List[str],
             gen: torch.Generator,
             baseline_caps: List[str] = None) -> Tuple[float, float]:
        """Sample, score against the baseline, take one Adam step; returns
        (loss, mean advantage)."""
        det, grp = self._inputs(detections, det_groups)
        if baseline_caps is None and self.baseline == "epoch":
            raise ValueError("baseline='epoch' requires baseline_caps "
                             "(from epoch_baseline_caps at epoch start)")
        ((words, gates), _), base = self._decode_batch(
            det, grp, gen, greedy=baseline_caps is None)
        if baseline_caps is None:
            baseline_caps = self._decode_caps(base)
        adv = self.rewards(self._decode_caps(words), baseline_caps, gt_caps)
        return self.grad_step(det, grp, words, gates, adv), float(
            np.mean(adv))
