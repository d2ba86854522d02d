"""Corpus BLEU-1..4 (pycocoevalcap/speaksee-compatible).

A copy of `vsrcic_tpu/metrics/bleu.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

Clipped n-gram precision accumulated over the corpus, closest-reference-length
brevity penalty, the scorer's tiny/small epsilons (reference usage:
coco_scripts/train.py:207, eval_coco.py:272).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

TINY = 1e-15
SMALL = 1e-9


def _ngrams(tokens: Sequence[str], n: int):
    counts = defaultdict(int)
    for i in range(len(tokens) - n + 1):
        counts[tuple(tokens[i:i + n])] += 1
    return counts


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict
                      ) -> Tuple[List[float], List[np.ndarray]]:
        n = self.n
        total_guess = np.zeros(n)
        total_correct = np.zeros(n)
        total_testlen = 0
        total_reflen = 0
        per_image = [np.zeros(len(gts)) for _ in range(n)]

        for i, k in enumerate(gts.keys()):
            hyp = (res[k][0] if isinstance(res[k], (list, tuple))
                   else res[k]).split()
            refs = [r.split() for r in gts[k]]
            testlen = len(hyp)
            # closest reference length (ties -> shorter)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            total_testlen += testlen
            total_reflen += reflen

            img_guess = np.zeros(n)
            img_correct = np.zeros(n)
            for j in range(1, n + 1):
                hyp_counts = _ngrams(hyp, j)
                max_ref = defaultdict(int)
                for r in refs:
                    for ng, c in _ngrams(r, j).items():
                        max_ref[ng] = max(max_ref[ng], c)
                guess = max(0, testlen - j + 1)
                correct = sum(min(c, max_ref[ng]) for ng, c in hyp_counts.items())
                img_guess[j - 1] = guess
                img_correct[j - 1] = correct
                total_guess[j - 1] += guess
                total_correct[j - 1] += correct

            # per-image scores (smoothed like the reference scorer's +1 option
            # is not used; use tiny/small)
            ratio = (testlen + TINY) / (reflen + SMALL)
            bp = 1.0 if ratio >= 1.0 else math.exp(1.0 - 1.0 / ratio)
            acc = 1.0
            for j in range(n):
                acc *= (img_correct[j] + TINY) / (img_guess[j] + SMALL)
                per_image[j][i] = (acc ** (1.0 / (j + 1))) * bp

        ratio = (total_testlen + TINY) / (total_reflen + SMALL)
        bp = 1.0 if ratio >= 1.0 else math.exp(1.0 - 1.0 / ratio)
        scores = []
        acc = 1.0
        for j in range(n):
            acc *= (total_correct[j] + TINY) / (total_guess[j] + SMALL)
            scores.append((acc ** (1.0 / (j + 1))) * bp)
        return scores, per_image
