"""Full eval composition: role-sort -> region-sort -> assignment rounding ->
rank merge -> feature permutation -> joint beam search.

Counterpart of `vsrcic_tpu/pipelines/eval_pipeline.py` (reference
coco_scripts/eval_coco.py:116-255, flickr_scripts/eval_flickr.py:120-262).
Each eval batch makes three batched device calls:

  1. one S-SSP constrained generate over ALL verb groups in the batch,
  2. one SinkhornNet forward over ALL ambiguous (verb, SR) pairs (its
     normalization is the Sinkhorn CUDA kernel on the card),
  3. one joint beam search over ALL (image, caption) pairs,

with the rank assembly, merge and permutation bookkeeping host-side in
numpy (metadata-sized; same semantics as the reference incl.
verb_rank_merge and the fill-tail-with-last-group recons layout, ref
eval_coco.py:222-237).

Host <-> device traffic never waits for more than it needs: index arrays
go up from pinned memory without blocking, and the plan's results come
back into pinned buffers behind a CUDA event that `plan_finish` waits on
alone. A blocking `.cpu()` would wait for everything enqueued on the
stream before it, including the previous batch's beam in `run_stream`.

Not ported yet: the `mesh` argument of the JAX class and its padded
sharded calls (`_pad_sharded`); they belong to the multi-GPU work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vsrcic_tpu_torch.models.api import ControllableCaptioner
from vsrcic_tpu_torch.models.s_ssp import (SSPConfig, ssp_generate,
                                           ssp_generate_fast)
from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                              sinkhorn_net_apply)
from vsrcic_tpu_torch.ops.assignment import hungarian_assign
from vsrcic_tpu_torch.ops.sinkhorn import (sinkhorn_normalize,
                                           sinkhorn_normalize_plain)
from vsrcic_tpu_torch.pipelines.sr_groups import (extract_verb_groups_arrays,
                                                  extract_verb_groups_batch)
from vsrcic_tpu_torch.utils.device import resolve_device, to_device
from vsrcic_tpu_torch.utils.rank_merge import verb_rank_merge


@dataclass
class CaptionJob:
    """One (image, caption) pair's control inputs (numpy, host)."""
    seqs_vis: np.ndarray       # (L, Dv)
    seqs_txt: np.ndarray       # (L, 300)
    seqs_pos: np.ndarray       # (L, 4)
    seqs_all: np.ndarray       # (L, M, D)
    control_verb: np.ndarray   # (8,)
    det_seqs_v: np.ndarray     # (L, 8)
    det_seqs_sr: np.ndarray    # (L, 8)
    verb_list: np.ndarray      # (L, 1)


@dataclass
class _PlanPending:
    """In-flight plan phase: the planner's preds and the Sinkhorn soft-perms
    being copied into host buffers (complete once `ready` has fired; None on
    the CPU), plus the host-side CSR bookkeeping plan_finish needs to
    assemble ranks."""
    n_jobs: int
    L: int
    jobs: Sequence["CaptionJob"]
    ga: object                       # verb-group arrays (None: no groups)
    preds: object = None
    P_soft: object = None            # None when no ambiguous pairs
    ready: object = None
    multi: np.ndarray = None
    rank_len: np.ndarray = None
    rank_off: np.ndarray = None
    rank_flat: np.ndarray = None
    locs_pad: np.ndarray = None
    valid: np.ndarray = None
    within: np.ndarray = None


class EvalPipeline:
    def __init__(self, captioner: ControllableCaptioner, ssp_params,
                 ssp_cfg: SSPConfig, sinkhorn_params,
                 sinkhorn_cfg: SinkhornConfig, eos_word: int,
                 fixed_len: int = 10, sinkhorn_len: int = 10,
                 beam_size: int = 5, gt: bool = False,
                 fast_ssp: bool = True, device=None,
                 plain_sinkhorn: bool = False):
        """ssp_params / sinkhorn_params: nested dicts of tensors or arrays
        in torch layout. device: the captioner's device ("cuda" unless
        given). fast_ssp: the KV-cached planner decode (token-exact vs the
        full-buffer one). plain_sinkhorn: normalize with the plain version
        on any device (a reference run on the card)."""
        self.device = resolve_device(device)
        if captioner.device != self.device:
            raise ValueError("the captioner runs on %s, the pipeline on %s"
                             % (captioner.device, self.device))
        self.captioner = captioner
        self.ssp_params = to_device(ssp_params, self.device)
        self.ssp_cfg = ssp_cfg
        self.sinkhorn_params = to_device(sinkhorn_params, self.device)
        self.sinkhorn_cfg = sinkhorn_cfg
        self.eos_word = eos_word
        self.fixed_len = fixed_len
        self.sinkhorn_len = sinkhorn_len
        self.beam_size = beam_size
        self.gt = gt
        self._gen = ssp_generate_fast if fast_ssp else ssp_generate
        self._normalize = (sinkhorn_normalize_plain if plain_sinkhorn
                           else sinkhorn_normalize)
        # recons are emitted in the beam's statics-table dtype (bf16 on the
        # fast path); M is not padded: the port's fused attention kernel
        # takes any M (the TPU kernel wanted a multiple of 8)
        self._recons_dtype = captioner.table_dtype

    # -- host <-> device ----------------------------------------------------
    def _put(self, a, dtype=None):
        """numpy -> tensor on the pipeline's device; on the card from pinned
        memory, without waiting for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _start_readback(self, *ts):
        """Enqueue copies of `ts` (tensors or None) into host buffers;
        returns (buffers, event). On the card the buffers are pinned and
        valid once the event (recorded right after the copies) has fired."""
        if self.device.type != "cuda":
            return list(ts), None
        bufs = []
        for t in ts:
            if t is not None:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                b.copy_(t, non_blocking=True)
                t = b
            bufs.append(t)
        ready = torch.cuda.Event()
        ready.record()
        return bufs, ready

    @staticmethod
    def _finish_readback(bufs, ready):
        """Wait for `ready` alone; the buffers as numpy arrays."""
        if ready is not None:
            ready.synchronize()
        return [None if b is None else b.numpy() for b in bufs]

    # ------------------------------------------------------------------
    def _ssp_gen(self, verbs, det_sr):
        """Constrained planner generate with the loop truncated to the
        batch's max slot count (bucketed to even lengths, as in JAX where
        each length is a compiled program). Each constrained step emits one
        unused input slot, so steps past the max slot count write the init
        values — truncation is output-identical (s_ssp._generate_loop).
        The slot count is read on host when det_sr is a numpy array (always,
        from plan_rank_batch); a tensor takes the full-length loop."""
        n_steps = self.ssp_cfg.max_len
        if isinstance(det_sr, np.ndarray) and det_sr.size:
            m = int((det_sr != 0).sum(axis=1).max())
            n_steps = min(n_steps, max(2, m + (m % 2)))
        if isinstance(verbs, np.ndarray):
            verbs, det_sr = self._put(verbs), self._put(det_sr)
        return self._gen(self.ssp_params, self.ssp_cfg, verbs, det_sr,
                         mode="not-normal", n_steps=n_steps)

    @torch.no_grad()
    def _sinkhorn_gather(self, vis, txt, pos, owner, locs, valid):
        """Sinkhorn inputs assembled on the device: row j of sink input s is
        concat(vis,txt,pos)[owner[s], locs[s, j]] for valid j, else 0 —
        exactly the reference's per-SR copy loop (eval_coco.py:178-183)."""
        feats = torch.cat([vis, txt, pos], -1)                 # (P, L, F)
        rows = feats[owner[:, None], locs]                     # (S, n, F)
        rows.masked_fill_(~valid[:, :, None], 0.0)
        return sinkhorn_net_apply(self.sinkhorn_params, self.sinkhorn_cfg,
                                  rows, normalize=self._normalize)

    def stage_job_feats(self, jobs: Sequence[CaptionJob]):
        """Device-stage the per-job (vis, txt, pos) tensors the Sinkhorn
        inputs are gathered from. Callers iterating over the same jobs can
        stage once and pass the result to plan/run (`sink_feats=`)."""
        return tuple(self._put(np.stack([getattr(j, f) for j in jobs]),
                               torch.float32)
                     for f in ("seqs_vis", "seqs_txt", "seqs_pos"))

    def plan_dispatch(self, jobs: Sequence[CaptionJob], sink_feats=None):
        """Enqueue the plan phase's device work (batched Sinkhorn +
        constrained planner) and the copies of its results to the host,
        without waiting for it; returns a pending handle for plan_finish.
        Splitting dispatch from finish lets a batch runner enqueue batch
        k+1's plan BEFORE batch k's beam (see run_stream)."""
        L = self.fixed_len
        n_jobs = len(jobs)

        ga = extract_verb_groups_arrays(
            np.stack([j.control_verb for j in jobs]),
            np.stack([j.det_seqs_v for j in jobs]),
            np.stack([j.det_seqs_sr for j in jobs]))
        if ga is None:
            return _PlanPending(n_jobs=n_jobs, L=L, jobs=jobs, ga=None)

        # Sinkhorn first, then the planner: the two are independent (the
        # planner orders roles, Sinkhorn orders regions within a role). rank
        # CSR: per (group, sr) pair the slots in final within-role order —
        # occurrence order for singletons, Hungarian order for ambiguous
        # pairs (truncated to sinkhorn_len, ref eval_coco.py:183-200)
        n = self.sinkhorn_len
        plen = ga.pair_len
        pair_off = ga.pair_off
        multi = np.nonzero(plen > 1)[0]
        rank_len = np.where(plen > 1, np.minimum(plen, n), plen)
        rank_off = np.concatenate([[0], np.cumsum(rank_len)])
        q_rep = np.repeat(np.arange(len(plen)), rank_len)
        within_r = np.arange(rank_off[-1]) - np.repeat(rank_off[:-1], rank_len)
        rank_flat = ga.slot_flat[pair_off[:-1][q_rep] + within_r]

        P_soft_dev = locs_pad = valid = within = None
        if multi.size:
            m = rank_len[multi]                                    # (S,)
            owner = ga.owners[ga.pair_group[multi]]
            within = np.arange(n)[None, :]                         # (1, n)
            valid = within < m[:, None]                            # (S, n)
            lo = pair_off[:-1][multi][:, None]
            hi = pair_off[1:][multi][:, None]
            locs_pad = np.where(
                valid, ga.slot_flat[np.minimum(lo + within, hi - 1)], 0)
            if sink_feats is None:
                sink_feats = self.stage_job_feats(jobs)
            P_soft_dev = self._sinkhorn_gather(
                *sink_feats, self._put(owner, torch.long),
                self._put(locs_pad, torch.long), self._put(valid))

        preds_dev, _ = self._ssp_gen(ga.verbs[:, None], ga.det_sr)
        (P_soft, preds), ready = self._start_readback(P_soft_dev, preds_dev)
        return _PlanPending(
            n_jobs=n_jobs, L=L, jobs=jobs, ga=ga, preds=preds, P_soft=P_soft,
            ready=ready, multi=multi, rank_len=rank_len, rank_off=rank_off,
            rank_flat=rank_flat, locs_pad=locs_pad, valid=valid,
            within=within)

    def plan_finish(self, pend: "_PlanPending"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for a plan_dispatch handle's copies (its event only) and run
        the host phases: Hungarian rounding + vectorized rank assembly +
        merge."""
        L, n_jobs, ga = pend.L, pend.n_jobs, pend.ga
        rank_idx = np.zeros((n_jobs, L), np.int32)
        rank_valid = np.zeros((n_jobs, L), bool)
        if ga is None:
            return rank_idx, rank_valid, np.full((n_jobs, L), -1.0)
        G = len(ga.owners)
        n = self.sinkhorn_len
        multi, rank_len, rank_off, rank_flat = (
            pend.multi, pend.rank_len, pend.rank_off, pend.rank_flat)
        locs_pad, valid, within = pend.locs_pad, pend.valid, pend.within

        P_soft, preds = self._finish_readback((pend.P_soft, pend.preds),
                                              pend.ready)
        if P_soft is not None:
            # profit = P^T as in the reference (eval_coco.py:185); row
            # assignments are a permutation so the valid entries are
            # distinct, and invalid slots are pushed past them with n+col
            assign = hungarian_assign(np.transpose(P_soft, (0, 2, 1)))
            ordv = np.argsort(np.where(valid, assign, n + within), axis=1)
            new_locs = np.take_along_axis(locs_pad, ordv, 1)       # (S, n)
            flat_idx = (rank_off[:-1][multi][:, None] + within)[valid]
            rank_flat[flat_idx] = new_locs[valid]
        jobs = pend.jobs

        # -- vectorized rank assembly + per-job merge ---------------------
        # per (group, pred position): which pair it selects (row-major order
        # = the loop's group-then-pred walk, ref eval_coco.py:202-211)
        pk = ga.pair_key
        pvalid = np.cumprod(preds != 0, axis=1).astype(bool)   # break at 0
        # guard both ends: a negative planner token would otherwise compute
        # g*sr_space + pred and alias into the PREVIOUS group's pair key
        safe = (preds > 0) & (preds < ga.sr_space)             # no key alias
        keys = np.where(safe,
                        np.arange(G)[:, None] * ga.sr_space + preds, -1)
        pos_q = np.searchsorted(pk, keys)
        found = np.where(pos_q < len(pk),
                         pk[np.minimum(pos_q, len(pk) - 1)] == keys, False)
        use = pvalid & safe & found
        gi_sel, _ = np.nonzero(use)
        sel_q = pos_q[use]
        counts = rank_len[sel_q]
        sel_off = np.concatenate([[0], np.cumsum(counts)])
        rep = np.repeat(np.arange(len(sel_q)), counts)
        within_s = np.arange(sel_off[-1]) - np.repeat(sel_off[:-1], counts)
        grank_flat = rank_flat[rank_off[:-1][sel_q][rep] + within_s]
        g_counts = np.bincount(gi_sel, weights=counts.astype(float),
                               minlength=G).astype(np.int64)
        g_off = np.concatenate([[0], np.cumsum(g_counts)])

        # jobs' groups are contiguous (owners nondecreasing by construction)
        job_g_off = np.searchsorted(ga.owners, np.arange(n_jobs + 1))
        ng = np.diff(job_g_off)

        # single-verb jobs (the common case): final rank IS the group rank —
        # vectorized scatter into the (P, L) plane
        single = np.nonzero(ng == 1)[0]
        if single.size:
            gsel = job_g_off[:-1][single]
            lens = np.minimum(g_counts[gsel], L)
            p_rep = np.repeat(single, lens)
            off = np.concatenate([[0], np.cumsum(lens)])
            w = np.arange(off[-1]) - np.repeat(off[:-1], lens)
            rank_idx[p_rep, w] = grank_flat[np.repeat(g_off[gsel], lens) + w]
            rank_valid[p_rep, w] = True

        # multi-verb jobs: sequential order-preserving merges (tiny lists)
        for p in np.nonzero(ng > 1)[0]:
            glo, ghi = job_g_off[p], job_g_off[p + 1]
            final = grank_flat[g_off[glo]:g_off[glo + 1]].tolist()
            for g in range(glo + 1, ghi):
                final = verb_rank_merge(
                    final, grank_flat[g_off[g]:g_off[g + 1]].tolist())
            k = min(len(final), L)
            rank_idx[p, :k] = final[:k]
            rank_valid[p, :k] = True

        # verb_list permuted on host (metadata-sized; exact perm math)
        job_vl = np.stack([np.asarray(j.verb_list).squeeze(-1) for j in jobs])
        verb_lists = np.where(
            rank_valid, np.take_along_axis(job_vl, rank_idx, 1), -1.0)
        return rank_idx, rank_valid, verb_lists

    def plan_rank_batch(self, jobs: Sequence[CaptionJob], sink_feats=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All jobs -> (rank_idx (P, L) int32, rank_valid (P, L) bool,
        verb_lists (P, L)) — the metadata-sized plan; features are permuted
        on device from these indices (see plan_batch/_build_recons_impl).

        Composition per job mirrors eval_coco.py:127-219 with the planner
        and Sinkhorn batched across jobs and every host phase numpy-
        vectorized; the only remaining Python loop is `verb_rank_merge` over
        multi-verb jobs. Equal to `plan_rank_batch_loop` (the tests pin it).
        Implemented as plan_dispatch + plan_finish (one wait)."""
        return self.plan_finish(self.plan_dispatch(jobs, sink_feats))

    def plan_rank_batch_loop(self, jobs: Sequence[CaptionJob], sink_feats=None
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reference (loop) implementation of plan_rank_batch — the oracle
        the vectorized path is pinned against; a direct transcription of
        eval_coco.py:127-219."""
        # -- phase A: extract verb groups --------------------------------
        all_groups, group_owner = extract_verb_groups_batch(
            np.stack([j.control_verb for j in jobs]),
            np.stack([j.det_seqs_v for j in jobs]),
            np.stack([j.det_seqs_sr for j in jobs]))

        # -- phase B: one batched constrained planner call ---------------
        if all_groups:
            verbs = np.asarray([[g.verb] for g in all_groups])
            det_sr = np.stack([g.det_sr_seq for g in all_groups])
            preds = self._ssp_gen(verbs, det_sr)[0].cpu().numpy()
        else:
            preds = np.zeros((0, self.ssp_cfg.max_len), np.int32)

        # -- phase C: batched Sinkhorn + host assignment -----------------
        sink_jobs: List[Tuple[int, int, List[int]]] = []  # (group_i, sr, locs)
        for gi, g in enumerate(all_groups):
            for sr in g.need_re_rank:
                sink_jobs.append((gi, sr, g.sr_find[sr]))

        sr_rank: Dict[Tuple[int, int], List[int]] = {}
        if sink_jobs:
            n = self.sinkhorn_len
            S = len(sink_jobs)
            owner = np.asarray([group_owner[gi] for gi, _, _ in sink_jobs])
            locs_pad = np.zeros((S, n), np.int64)
            valid = np.zeros((S, n), bool)
            for s, (_, _, locs) in enumerate(sink_jobs):
                m = min(len(locs), n)
                locs_pad[s, :m] = locs[:m]
                valid[s, :m] = True
            if sink_feats is None:
                sink_feats = self.stage_job_feats(jobs)
            P_soft = self._sinkhorn_gather(
                *sink_feats, self._put(owner, torch.long),
                self._put(locs_pad), self._put(valid)).cpu().numpy()
            # profit = P^T as in the reference (eval_coco.py:185)
            assign = hungarian_assign(np.transpose(P_soft, (0, 2, 1)))
            for (gi, sr, locs), ass in zip(sink_jobs, assign):
                sr_re = np.asarray(ass[:len(locs)])
                order = np.argsort(sr_re)
                sr_rank[(gi, sr)] = [locs[int(o)] for o in order]

        # -- phase D: rank assembly + merge (host, metadata-sized) ---------
        L = self.fixed_len
        n_jobs = len(jobs)
        rank_idx = np.zeros((n_jobs, L), np.int32)
        rank_valid = np.zeros((n_jobs, L), bool)
        verb_lists = np.full((n_jobs, L), -1.0)

        per_job_ranks: List[List[List[float]]] = [[] for _ in range(n_jobs)]
        for gi, g in enumerate(all_groups):
            verb_rank: List[float] = []
            for sr_ in preds[gi]:
                sr_ = int(sr_)
                if sr_ == 0:
                    break
                if sr_ not in g.sr_find:
                    continue
                if len(g.sr_find[sr_]) != 1:
                    verb_rank += list(sr_rank[(gi, sr_)])
                else:
                    verb_rank += g.sr_find[sr_]
            per_job_ranks[group_owner[gi]].append(verb_rank)

        for p, job in enumerate(jobs):
            ranks = per_job_ranks[p]
            if not ranks:
                final_rank: List[float] = []
            else:
                final_rank = ranks[0]
                for extra in ranks[1:]:
                    final_rank = verb_rank_merge(final_rank, extra)
            for j, rk in enumerate(final_rank):
                if j < L:
                    rank_idx[p, j] = int(rk)
                    rank_valid[p, j] = True
            vl = np.full((L,), -1.0)
            vl[rank_valid[p]] = np.asarray(job.verb_list).squeeze(-1)[
                rank_idx[p][rank_valid[p]]]
            verb_lists[p] = vl
        return rank_idx, rank_valid, verb_lists

    def stage_seqs_all(self, jobs: Sequence[CaptionJob]):
        """Device-stage the (P, L, M, D) group-feature tensor for the recons
        build: f32 row sums are taken FIRST (exact liveness), then the
        tensor is stored in the recons dtype (bf16 on the fast path —
        gather and cast commute, so values are identical). Returns
        (seqs_all, row_sums)."""
        arr = self._put(np.stack([j.seqs_all for j in jobs]), torch.float32)
        row_sums = arr.sum((2, 3))
        if self._recons_dtype is not None:
            arr = arr.to(self._recons_dtype)
        return arr, row_sums

    @staticmethod
    def _as_staged(seqs_all):
        """Accept stage_seqs_all's (arr, row_sums) or a raw device tensor."""
        if isinstance(seqs_all, tuple):
            return seqs_all
        return seqs_all, seqs_all.float().sum((2, 3))

    def _build_recons(self, arr, rank_idx, rank_valid, row_sums):
        return self._build_recons_impl(arr, self._put(rank_idx, torch.long),
                                       self._put(rank_valid), row_sums)

    def plan_batch(self, jobs: Sequence[CaptionJob]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """All jobs -> (recons (P, L, M, D) f32 numpy, verb_lists (P, L)).

        The feature permutation is built on the device from the (rank,
        valid) indices: each perm-matrix row has one 1, so the gather equals
        the reference's `perm_matrix @ flat` exactly (ref
        eval_coco.py:222-231)."""
        recons, verb_lists = self.plan_batch_device(jobs)
        return recons.float().cpu().numpy(), verb_lists

    def plan_batch_device(self, jobs, seqs_all=None, sink_feats=None):
        """plan_rank_batch + device recons, keeping the features on the
        device. seqs_all: pre-staged stage_seqs_all output (or a raw (P, L,
        M, D) device tensor; staged here if None). Returns (recons device
        tensor, verb_lists host array)."""
        rank_idx, rank_valid, verb_lists = self.plan_rank_batch(
            jobs, sink_feats=sink_feats)
        if seqs_all is None:
            seqs_all = self.stage_seqs_all(jobs)
        arr, row_sums = self._as_staged(seqs_all)
        return self._build_recons(arr, rank_idx, rank_valid,
                                  row_sums), verb_lists

    @staticmethod
    def _build_recons_impl(seqs_all, rank_idx, rank_valid, row_sums=None):
        """Device recons: gather rows by rank, drop all-zero rows compacting
        to the front (stable), fill the tail with the last non-zero row —
        semantics of ref eval_coco.py:229-237.

        All index bookkeeping happens on the small (P, L) plane, so the big
        (P, L, M, D) tensor is touched by one gather, indexed on its (P, L)
        plane (an index expanded to the full tensor would be larger than
        the tensor). `row_sums` (P, L) may be precomputed in f32 at staging
        time (stage_seqs_all), which lets the big tensor be stored bf16."""
        P, L = rank_idx.shape
        if row_sums is None:
            row_sums = seqs_all.float().sum((2, 3))               # (P, L)
        g_sums = torch.gather(row_sums, 1, rank_idx)
        nz = rank_valid & (g_sums != 0)                           # live rows
        order = torch.sort((~nz).to(torch.int8), dim=1,
                           stable=True).indices                   # nz first
        n = nz.sum(1)                                             # (P,)
        last = (n - 1).clamp(0, L - 1)
        rows = torch.arange(L, device=rank_idx.device)[None, :]
        src = torch.where(rows < n[:, None], rows, last[:, None])  # tail fill
        comp = torch.gather(order, 1, src)
        idx = torch.gather(rank_idx, 1, comp)
        valid_c = torch.gather(nz, 1, comp)
        p_idx = torch.arange(P, device=rank_idx.device)[:, None]
        out = seqs_all[p_idx, idx]                                # (P, L, M, D)
        return out.masked_fill_(~valid_c[:, :, None, None], 0.0)

    # ------------------------------------------------------------------
    def _dispatch_beam(self, detections_per_job, recons, verb_lists,
                       n_jobs: int):
        """Enqueue the joint beam search; returns the still-computing (P, T)
        best-beam device tensor."""
        res = self.captioner.beam_search_v(
            detections_per_job, recons, self._put(verb_lists, torch.long),
            eos_word=self.eos_word, beam_size=self.beam_size, gt=self.gt)
        return res.words[:n_jobs, 0]

    def submit_batch(self, detections_per_job, jobs: Sequence[CaptionJob],
                     seqs_all=None, sink_feats=None):
        """Plan + dispatch the beam WITHOUT reading back the result: the
        returned (P, T) device tensor is still computing.

        NOTE: for multi-batch streams prefer run_stream — submit_batch
        enqueues batch k+1's plan AFTER batch k's beam, so the plan
        readback waits out the whole beam on the device queue."""
        recons, verb_lists = self.plan_batch_device(
            jobs, seqs_all=seqs_all, sink_feats=sink_feats)
        return self._dispatch_beam(detections_per_job, recons, verb_lists,
                                   len(jobs))

    def run_stream(self, batches):
        """Software-pipelined eval over a stream of batches; yields the
        best-beam words (P, T) numpy array per batch, in order.

        `batches` is an iterable of (detections_per_job, jobs) or
        (detections_per_job, jobs, staged_seqs_all, staged_sink_feats)
        tuples (staged entries may be None; they are staged here).

        Schedule (1 batch ahead): batch k+1's planner/Sinkhorn work and its
        readback are enqueued BEFORE batch k's beam, so on the device queue
        they run first and plan_finish(k+1) waits only for them, not for
        beam k; the Hungarian rounding + rank assembly for k+1 then overlap
        the rest of beam k. Words come back the same way, behind their own
        event.
        """
        it = iter(batches)

        def norm(b):
            dets, jobs = b[0], b[1]
            seqs_all = b[2] if len(b) > 2 else None
            sink_feats = b[3] if len(b) > 3 else None
            if sink_feats is None:
                sink_feats = self.stage_job_feats(jobs)
            if seqs_all is None:
                seqs_all = self.stage_seqs_all(jobs)
            return dets, jobs, self._as_staged(seqs_all), sink_feats

        try:
            cur = norm(next(it))
        except StopIteration:
            return
        pend_plan = self.plan_dispatch(cur[1], sink_feats=cur[3])
        pend_words = None
        while cur is not None:
            dets, jobs, (arr, row_sums), _ = cur
            rank_idx, rank_valid, verb_lists = self.plan_finish(pend_plan)
            recons = self._build_recons(arr, rank_idx, rank_valid, row_sums)
            # stage + dispatch NEXT batch's plan before this batch's beam
            try:
                nxt = norm(next(it))
            except StopIteration:
                nxt = None
            if nxt is not None:
                pend_plan = self.plan_dispatch(nxt[1], sink_feats=nxt[3])
            words = self._start_readback(self._dispatch_beam(
                dets, recons, verb_lists, len(jobs)))
            if pend_words is not None:
                yield self._finish_readback(*pend_words)[0]
            pend_words = words
            cur = nxt
        yield self._finish_readback(*pend_words)[0]

    def run_batch(self, detections_per_job, jobs: Sequence[CaptionJob],
                  seqs_all=None, sink_feats=None) -> np.ndarray:
        """detections_per_job: (P, N, D) raw detections (image's detections
        repeated per caption). Returns best-beam words (P, T)."""
        return self.submit_batch(detections_per_job, jobs, seqs_all=seqs_all,
                                 sink_feats=sink_feats).cpu().numpy()
