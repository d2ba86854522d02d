"""Assignment rounding for Sinkhorn soft permutations.

Counterpart of `vsrcic_tpu/ops/assignment.py::hungarian_assign`, copied (the
port imports nothing of the JAX package). The reference rounds each soft
permutation with the pure-Python `munkres` package per example inside the
eval loop (reference eval_coco.py:188-199: `munkres.make_cost_matrix(mx)`
then `Munkres().compute`); here scipy's C Jonker-Volgenant runs on the host,
batched over all pairs of an eval batch at once.
"""
from __future__ import annotations

import numpy as np


def hungarian_assign(profit: np.ndarray) -> np.ndarray:
    """Max-profit assignment. profit: (..., N, N) -> (..., N) col per row.

    Matches the reference's munkres usage: make_cost_matrix converts profit
    to cost (max - p) and Munkres minimizes, i.e. profit maximization.
    """
    from scipy.optimize import linear_sum_assignment

    p = np.asarray(profit)
    if p.ndim == 2:
        rows, cols = linear_sum_assignment(-p)
        out = np.empty(p.shape[0], np.int64)
        out[rows] = cols
        return out
    return np.stack([hungarian_assign(x) for x in p])
