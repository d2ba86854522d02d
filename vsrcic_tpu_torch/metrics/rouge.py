"""ROUGE-L (pycocoevalcap/speaksee-compatible): LCS F-measure, beta=1.2.

A copy of `vsrcic_tpu/metrics/rouge.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _lcs_len(a, b) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, hyp: str, refs) -> float:
        h = hyp.split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(h, r)
            prec.append(lcs / len(h) if h else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, rc = max(prec), max(rec)
        if p != 0 and rc != 0:
            return ((1 + self.beta ** 2) * p * rc) / (rc + self.beta ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        scores = np.array([
            self.calc_score(
                res[k][0] if isinstance(res[k], (list, tuple)) else res[k],
                gts[k])
            for k in gts.keys()])
        return float(np.mean(scores)) if len(scores) else 0.0, scores
