"""Per-verb semantic-role group extraction.

A copy of `vsrcic_tpu/pipelines/sr_groups.py`, host numpy (the port imports
nothing of the JAX package).

The reference repeats this nested Python grid scan inline in three places
(train_region_sort.py:134-179, train_sinkhorn.py:144-205,
eval_coco.py:149-167): for each control verb, walk the (fix_length, 8)
verb/SR grids and collect, per distinct SR value, the region slots carrying
it — producing the planner input sequence and the "needs re-ranking" SR set.

Here it is one host-side function producing metadata-sized outputs that feed
*batched* device calls (the planner/Sinkhorn consume whole batches of groups
at once instead of the reference's one-at-a-time model invocations). Runs in
the input pipeline, off the device critical path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np


@dataclass
class VerbGroup:
    verb: float                       # raw verb code (flickr keeps 10000*occ)
    det_sr_seq: np.ndarray            # (fix_length,) planner input SRs, 0-pad
    sr_find: Dict[int, List[int]]     # sr value -> slots carrying it
    need_re_rank: Set[int] = field(default_factory=set)
    gt_sr_seq: Optional[np.ndarray] = None


def extract_verb_groups(control_verb, det_seqs_v, det_seqs_sr,
                        gt_seqs_v=None, gt_seqs_sr=None,
                        max_sr: int = 10) -> List[VerbGroup]:
    """One caption's control grids -> list of VerbGroup (ref semantics).

    control_verb: (8,); det_seqs_v/det_seqs_sr: (fix_length, 8);
    optionally gt grids for training-target extraction.
    """
    control_verb = np.asarray(control_verb)
    det_seqs_v = np.asarray(det_seqs_v)
    det_seqs_sr = np.asarray(det_seqs_sr)
    groups: List[VerbGroup] = []
    fix_length = det_seqs_sr.shape[0]

    for verb in control_verb:
        if verb == 0:
            break
        det_sr_seq = np.zeros(fix_length, det_seqs_sr.dtype)
        find_sr = 0
        sr_find: Dict[int, List[int]] = {}
        need_re_rank: Set[int] = set()
        for j in range(det_seqs_v.shape[0]):
            for k in range(det_seqs_v.shape[1]):
                if det_seqs_v[j][k] == verb and find_sr < max_sr:
                    sr = int(det_seqs_sr[j][k])
                    if sr not in sr_find:
                        sr_find[sr] = [j]
                        det_sr_seq[find_sr] = det_seqs_sr[j][k]
                        find_sr += 1
                    else:
                        sr_find[sr].append(j)
                        need_re_rank.add(sr)
        if find_sr == 0:
            continue

        gt_sr_seq = None
        if gt_seqs_v is not None:
            gt_seqs_v_a = np.asarray(gt_seqs_v)
            gt_seqs_sr_a = np.asarray(gt_seqs_sr)
            gt_sr_seq = np.zeros(fix_length, gt_seqs_sr_a.dtype)
            find_gt = 0
            gt_seen: List[float] = []
            for j in range(gt_seqs_v_a.shape[0]):
                for k in range(gt_seqs_v_a.shape[1]):
                    if (gt_seqs_v_a[j][k] == verb and find_gt < max_sr
                            and gt_seqs_sr_a[j][k] not in gt_seen):
                        gt_seen.append(gt_seqs_sr_a[j][k])
                        gt_sr_seq[find_gt] = gt_seqs_sr_a[j][k]
                        find_gt += 1
            gt_sr_seq = gt_sr_seq
        groups.append(VerbGroup(verb=float(verb), det_sr_seq=det_sr_seq,
                                sr_find=sr_find, need_re_rank=need_re_rank,
                                gt_sr_seq=gt_sr_seq))
    return groups


def batch_planner_inputs(groups: List[VerbGroup]):
    """Stack groups into (verb (N,1), det_sr (N,L)[, gt_sr (N,L)]) arrays."""
    if not groups:
        return None
    verbs = np.asarray([[g.verb] for g in groups])
    det_sr = np.stack([g.det_sr_seq for g in groups])
    if groups[0].gt_sr_seq is not None:
        gt_sr = np.stack([g.gt_sr_seq for g in groups])
        return verbs, det_sr, gt_sr
    return verbs, det_sr


def _match_core(control_verbs, det_seqs_v_all, det_seqs_sr_all, max_sr):
    """Shared vectorized core of the batch extractors: the (P, 8, T, 8)
    match mask, first-occurrence ranks, the reference truncation quirk and
    group boundaries, all in numpy. Returns None when there are no matches,
    else a dict of flat per-kept-match arrays + group boundary arrays."""
    cv = np.asarray(control_verbs)
    V = np.asarray(det_seqs_v_all)
    S = np.asarray(det_seqs_sr_all)
    P, T, K8 = V.shape
    n_verbs = cv.shape[1]

    keep_verb = np.cumprod(cv != 0, axis=1).astype(bool)    # until first 0
    # match mask over (P, n_verbs, T, 8); np.nonzero returns row-major order
    M = (V[:, None, :, :] == cv[:, :, None, None]) & keep_verb[:, :, None, None]
    p_i, v_i, j_i, k_i = np.nonzero(M)
    if len(p_i) == 0:
        return None
    sr_f = S[p_i, j_i, k_i]
    sr_int = sr_f.astype(np.int64)
    gid = p_i.astype(np.int64) * n_verbs + v_i

    # group boundaries (gid ascending because np.nonzero is lexicographic)
    uniq_gid, g_start = np.unique(gid, return_index=True)
    g_of = np.searchsorted(uniq_gid, gid)                   # dense group idx
    pos = np.arange(len(gid)) - g_start[g_of]               # pos within group

    # first occurrence of each (group, sr) — the key packing below requires
    # non-negative SR values (survives `python -O`, unlike an assert)
    if sr_int.min() < 0:
        raise ValueError("negative SR value %d in det_seqs_sr; group key "
                         "packing requires SR >= 0" % int(sr_int.min()))
    sr_space = int(sr_int.max()) + 1
    key = gid * sr_space + sr_int
    uniq_key, first_idx = np.unique(key, return_index=True)
    is_first = np.zeros(len(gid), bool)
    is_first[first_idx] = True

    # truncation: match kept iff #(distinct-sr first occurrences earlier in
    # its group) < max_sr
    firsts_pos = pos[is_first]
    firsts_g = g_of[is_first]
    order = np.lexsort((firsts_pos, firsts_g))
    firsts_pos_sorted = firsts_pos[order]
    fg_uniq, fg_start = np.unique(firsts_g[order], return_index=True)
    # per-match: count firsts in its group with pos < the match's pos —
    # encode (group, pos) into one sortable key and searchsorted against
    # the (group, first_pos) keys, then subtract the group's slice start
    f_start = fg_start[np.searchsorted(fg_uniq, g_of)]
    BIG = T * K8 + 2
    firsts_key_sorted = firsts_g[order] * BIG + firsts_pos_sorted
    match_key = g_of * BIG + pos
    n_before = (np.searchsorted(firsts_key_sorted, match_key, side="left")
                - f_start)
    kept = n_before < max_sr

    return dict(
        cv=cv, T=T, n_verbs=n_verbs, sr_dtype=S.dtype, sr_space=sr_space,
        uniq_gid=uniq_gid,
        kept_g=g_of[kept], kept_j=j_i[kept], kept_sr_f=sr_f[kept],
        kept_sr_i=sr_int[kept], kept_first=is_first[kept])


def extract_verb_groups_batch(control_verbs, det_seqs_v_all, det_seqs_sr_all,
                              max_sr: int = 10):
    """Vectorized extract_verb_groups over a whole batch of jobs.

    control_verbs: (P, 8); det_seqs_v_all/det_seqs_sr_all: (P, T, 8).
    Returns (groups, owners) — the same VerbGroups, in the same order, as
    running extract_verb_groups per job (fuzz-pinned by
    tests/test_sr_groups_batch.py, incl. the reference's truncation quirk:
    once the max_sr-th DISTINCT role has appeared, every later match is
    dropped entirely, even repeats of already-seen roles).

    The per-(job, verb) grid scan is the eval pipeline's largest host slice
    (~34 ms per 1024 jobs as a Python loop); here everything up to the final
    VerbGroup assembly is numpy (`_match_core`).
    """
    core = _match_core(control_verbs, det_seqs_v_all, det_seqs_sr_all, max_sr)
    if core is None:
        return [], []
    cv, T, n_verbs = core["cv"], core["T"], core["n_verbs"]
    uniq_gid = core["uniq_gid"]
    kept_g, kept_j = core["kept_g"], core["kept_j"]
    kept_sr_f, kept_sr_i = core["kept_sr_f"], core["kept_sr_i"]
    kept_first = core["kept_first"]

    groups: List[VerbGroup] = []
    owners: List[int] = []
    # assemble per group (boundaries via searchsorted on the kept subset)
    bounds = np.searchsorted(kept_g, np.arange(len(uniq_gid) + 1))
    sr_dtype = core["sr_dtype"]
    for g in range(len(uniq_gid)):
        lo, hi = bounds[g], bounds[g + 1]
        if lo == hi:
            continue
        p = int(uniq_gid[g]) // n_verbs
        vi = int(uniq_gid[g]) % n_verbs
        det_sr_seq = np.zeros(T, sr_dtype)
        sr_find: Dict[int, List[int]] = {}
        need: Set[int] = set()
        f = 0
        for x in range(lo, hi):
            sr = int(kept_sr_i[x])
            if kept_first[x]:
                sr_find[sr] = [int(kept_j[x])]
                det_sr_seq[f] = kept_sr_f[x]
                f += 1
            else:
                sr_find[sr].append(int(kept_j[x]))
                need.add(sr)
        groups.append(VerbGroup(verb=float(cv[p, vi]), det_sr_seq=det_sr_seq,
                                sr_find=sr_find, need_re_rank=need))
        owners.append(p)
    return groups, owners


@dataclass
class GroupArrays:
    """Array (CSR) form of a batch's verb groups — the fully-vectorized
    counterpart of `extract_verb_groups_batch`'s VerbGroup list, consumed
    by the eval pipeline's vectorized rank assembly (no per-group Python).

    Groups are ordered exactly as `extract_verb_groups_batch` emits them
    (job-major, then control-verb order). (group, sr) pairs are ordered by
    (group, sr value) so `pair_key` is sorted and lookups are searchsorted.
    Slots within a pair are in grid occurrence order (= reference sr_find).
    """
    owners: np.ndarray       # (G,) int64 — owning job per group
    verbs: np.ndarray        # (G,) float — raw verb codes
    det_sr: np.ndarray       # (G, T) planner input SR seqs, 0-padded
    pair_group: np.ndarray   # (Q,) int64 — dense group index per pair
    pair_sr: np.ndarray      # (Q,) int64 — SR value per pair
    pair_off: np.ndarray     # (Q+1,) int64 — CSR offsets into slot_flat
    slot_flat: np.ndarray    # (R,) int64 — region slots, occurrence order
    sr_space: int            # pair_key = pair_group * sr_space + pair_sr

    @property
    def pair_key(self) -> np.ndarray:
        return self.pair_group * self.sr_space + self.pair_sr

    @property
    def pair_len(self) -> np.ndarray:
        return self.pair_off[1:] - self.pair_off[:-1]


def extract_verb_groups_arrays(control_verbs, det_seqs_v_all,
                               det_seqs_sr_all, max_sr: int = 10
                               ) -> Optional[GroupArrays]:
    """Batch verb-group extraction straight to arrays (no VerbGroup objects,
    no per-group Python loop). Oracle-equivalent to
    `extract_verb_groups_batch` (tests/test_sr_groups_batch.py)."""
    core = _match_core(control_verbs, det_seqs_v_all, det_seqs_sr_all, max_sr)
    if core is None:
        return None
    cv, T, n_verbs = core["cv"], core["T"], core["n_verbs"]
    uniq_gid = core["uniq_gid"]
    kept_g, kept_j = core["kept_g"], core["kept_j"]
    kept_sr_f, kept_sr_i = core["kept_sr_f"], core["kept_sr_i"]
    kept_first = core["kept_first"]
    G = len(uniq_gid)

    owners = uniq_gid // n_verbs
    verbs = cv[owners, uniq_gid % n_verbs].astype(float)

    # det_sr: firsts, in occurrence order, scattered to their first-rank
    f_idx = np.nonzero(kept_first)[0]                     # group-major order
    fg = kept_g[f_idx]
    _, fstart = np.unique(fg, return_index=True)          # every group has >=1
    frank = np.arange(len(f_idx)) - fstart[np.searchsorted(np.unique(fg), fg)]
    det_sr = np.zeros((G, T), core["sr_dtype"])
    det_sr[fg, frank] = kept_sr_f[f_idx]

    # (group, sr) pairs: stable-sort matches by (group, sr value) to get
    # per-pair slot runs with occurrence order preserved inside each run
    sr_space = core["sr_space"]
    mkey = kept_g * sr_space + kept_sr_i
    order = np.argsort(mkey, kind="stable")
    slot_flat = kept_j[order].astype(np.int64)
    ukey, ustart = np.unique(mkey[order], return_index=True)
    pair_off = np.concatenate([ustart, [len(slot_flat)]]).astype(np.int64)
    return GroupArrays(owners=owners, verbs=verbs, det_sr=det_sr,
                       pair_group=ukey // sr_space, pair_sr=ukey % sr_space,
                       pair_off=pair_off, slot_flat=slot_flat,
                       sr_space=sr_space)
