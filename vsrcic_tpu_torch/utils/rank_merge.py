"""Order-preserving merge of two ranked index lists that share elements.

A copy of `vsrcic_tpu/utils/rank_merge.py` (the port imports nothing of the
JAX package). Behavioral re-implementation of the reference's
`verb_rank_merge` (utils/tools.py:35-71), used at eval time to merge
per-verb region-rank lists into one caption-level order. Host-side: inputs
are tiny (<=10 elements per caption) and the algorithm is inherently
sequential.
"""
from __future__ import annotations

from typing import List, Sequence


def verb_rank_merge(la: Sequence, lb: Sequence) -> List:
    la = list(la)
    lb = list(lb)
    merged = list(la)

    # Elements common to both lists, in la's order, plus their positions in lb.
    same = []
    pos_in_b = []
    for a in la:
        for j, b in enumerate(lb):
            if a == b:
                same.append(a)
                pos_in_b.append(j)
                break

    # If lb orders the shared elements differently than la, rewrite lb so the
    # shared elements appear in la's order at lb's (sorted) shared positions.
    sorted_pos = sorted(pos_in_b)
    if pos_in_b != sorted_pos:
        for j, p in enumerate(sorted_pos):
            lb[p] = same[j]

    # For each non-shared element of lb, find its right neighbor that IS
    # shared; insert it just before that neighbor in the merged list (or
    # append if it has none).
    right = None
    right_of = {}
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
                for j, m in enumerate(merged):
                    if m == r:
                        merged.insert(j, x)
                        break
    return merged
