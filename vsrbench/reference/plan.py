"""The eval plan in plain NumPy/SciPy and PyTorch, as the reference's
`coco_scripts/eval_coco.py:127-237` composes it, one job at a time.

  * `verb_groups`: per control verb, the input slots of each role in
    occurrence order (at most `max_sr` distinct roles), the planner's role
    sequence, and the roles held by more than one slot;
  * `compose`: given each group's role order and each ambiguous (group,
    role) pair's soft permutation, the Hungarian order of the pair's slots
    (SciPy's assignment on the transposed matrix, as munkres is fed), each
    verb's rank list, the merge of a job's verbs' lists, and the verb list
    permuted by the ranks;
  * `recons`: each job's region groups gathered in rank order, groups that
    are all zero dropped, the tail filled with the last group kept.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def verb_groups(control_verb, det_v, det_sr, max_sr=10):
    """One job's groups: list of (verb, det_sr_seq (L,), {role: [slots]},
    sorted roles held by more than one slot)."""
    groups = []
    length = det_sr.shape[0]
    for verb in control_verb:
        if verb == 0:
            break
        seq = np.zeros(length, det_sr.dtype)
        found = {}
        n = 0
        for j in range(det_v.shape[0]):
            for k in range(det_v.shape[1]):
                if det_v[j][k] == verb and n < max_sr:
                    sr = int(det_sr[j][k])
                    if sr not in found:
                        found[sr] = [j]
                        seq[n] = det_sr[j][k]
                        n += 1
                    else:
                        found[sr].append(j)
        if n:
            multi = sorted(sr for sr, slots in found.items()
                           if len(slots) > 1)
            groups.append((float(verb), seq, found, multi))
    return groups


def rank_merge(la, lb) -> List:
    """The reference's `verb_rank_merge` (utils/tools.py:35-71): merge lb
    into la keeping la's order of the shared elements."""
    la, lb = list(la), list(lb)
    merged = list(la)
    same, pos_b = [], []
    for a in la:
        for j, b in enumerate(lb):
            if a == b:
                same.append(a)
                pos_b.append(j)
                break
    ordered = sorted(pos_b)
    if pos_b != ordered:
        for j, p in enumerate(ordered):
            lb[p] = same[j]
    right, right_of = None, {}
    for x in reversed(lb):
        if x not in same:
            right_of[x] = right
        else:
            right = x
    for x in lb:
        if x not in same:
            r = right_of[x]
            if r is None:
                merged.append(x)
            else:
                merged.insert(merged.index(r), x)
    return merged


def sinkhorn_rows(groups_per_job, n):
    """The ambiguous pairs of a batch in (group, role) order: per pair the
    owning job, the slots (first n, occurrence order) and a validity mask,
    as (owner (S,), locs (S, n), valid (S, n))."""
    owner, locs, valid = [], [], []
    for p, groups in enumerate(groups_per_job):
        for _, _, found, multi in groups:
            for sr in multi:
                slots = found[sr][:n]
                owner.append(p)
                locs.append(slots + [0] * (n - len(slots)))
                valid.append([True] * len(slots) + [False] * (n - len(slots)))
    return (np.asarray(owner, np.int64), np.asarray(locs, np.int64).reshape(-1, n),
            np.asarray(valid, bool).reshape(-1, n))


def compose(groups_per_job, preds, soft_perms, verb_list, length, n):
    """Ranks of every job from its groups' role orders preds (G, T) and
    the pairs' soft permutations (S, n, n) in `sinkhorn_rows` order.
    verb_list (P, L) -> (rank_idx (P, L) int, rank_valid (P, L) bool,
    verb_lists (P, L) float)."""
    n_jobs = len(groups_per_job)
    rank_idx = np.zeros((n_jobs, length), np.int64)
    rank_valid = np.zeros((n_jobs, length), bool)
    verb_lists = np.full((n_jobs, length), -1.0)
    gi = si = 0
    for p, groups in enumerate(groups_per_job):
        lists = []
        for _, _, found, multi in groups:
            order = {}
            for sr in multi:
                slots = found[sr][:n]
                rows, cols = linear_sum_assignment(-soft_perms[si].T)
                assign = np.empty(n, np.int64)
                assign[rows] = cols
                within = np.argsort(assign[:len(slots)], kind="stable")
                order[sr] = [slots[int(o)] for o in within]
                si += 1
            ranks = []
            for sr in preds[gi]:
                sr = int(sr)
                if sr == 0:
                    break
                if sr in found:
                    ranks += order[sr] if sr in order else found[sr]
            lists.append(ranks)
            gi += 1
        final = lists[0] if lists else []
        for extra in lists[1:]:
            final = rank_merge(final, extra)
        for j, r in enumerate(final[:length]):
            rank_idx[p, j] = int(r)
            rank_valid[p, j] = True
            verb_lists[p, j] = verb_list[p, int(r)]
    return rank_idx, rank_valid, verb_lists


@torch.no_grad()
def recons(seqs_all, rank_idx, rank_valid):
    """seqs_all (P, L, M, D) device tensor, rank_idx / rank_valid (P, L)
    numpy -> (P, L, M, D): per job the ranked groups that are not all
    zero, in rank order, the tail filled with the last of them (zeros when
    none)."""
    n_jobs, length = rank_idx.shape
    sums = seqs_all.sum((2, 3)).cpu().numpy()
    src = np.zeros((n_jobs, length), np.int64)
    keep = np.zeros((n_jobs, length), bool)
    for p in range(n_jobs):
        live = [int(r) for r, v in zip(rank_idx[p], rank_valid[p])
                if v and sums[p, int(r)] != 0]
        if live:
            src[p] = live + [live[-1]] * (length - len(live))
            keep[p] = True
    dev = seqs_all.device
    out = seqs_all[torch.arange(n_jobs, device=dev)[:, None],
                   torch.from_numpy(src).to(dev)]
    return out * torch.from_numpy(keep).to(dev)[:, :, None, None]
