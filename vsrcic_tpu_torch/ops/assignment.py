"""Assignment rounding for Sinkhorn soft permutations.

Counterpart of `vsrcic_tpu/ops/assignment.py`, copied (the port imports
nothing of the JAX package). The reference rounds each soft permutation
with the pure-Python `munkres` package per example inside the eval loop
(reference eval_coco.py:188-199: `munkres.make_cost_matrix(mx)` then
`Munkres().compute`). Here:

  * `hungarian_assign`: scipy's C Jonker-Volgenant on the host, batched
    over all pairs of an eval batch at once;
  * `greedy_assign_device`: greedy max rounding that stays on the profit's
    device (for tau as low as the reference's 0.1 the Sinkhorn output is
    near-hard and both rounding schemes agree).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vsrcic_tpu_torch.core.nn import first_argmax


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


def greedy_assign_device(profit):
    """Greedy max rounding, n rounds: take the first maximum of the
    flattened (N, N) profit in row-major order (as `jnp.argmax` does), then
    mask its row and column with -inf. profit: (N, N) -> (N,) int32 column
    per row, on the profit's device."""
    n = profit.shape[-1]
    p = profit.to(torch.float32).clone()
    out = torch.zeros((n,), dtype=torch.int32, device=p.device)
    for _ in range(n):
        flat = first_argmax(p.reshape(-1))
        r, c = flat // n, flat % n
        out[r] = c.to(torch.int32)
        p[r, :] = -math.inf
        p[:, c] = -math.inf
    return out
