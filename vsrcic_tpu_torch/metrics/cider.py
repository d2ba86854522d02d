"""Native CIDEr-D scorer.

A copy of `vsrcic_tpu/metrics/cider.py` (numpy only): the port imports
nothing of the JAX package, not even its JAX-free modules.

The reference computes CIDEr inside the SCST training step through Java
tokenization + the pycocoevalcap scorer via speaksee (reference
coco_scripts/train.py:67,169-170). This is a dependency-free implementation
of the same algorithm (n-gram tf-idf cosine with count clipping and gaussian
length penalty, n=1..4, sigma=6, score x10), with a corpus-df mode matching
`evaluation.Cider(PTBTokenizer.tokenize(ref_caps_train))`.

Pure host-side Python/numpy: per-batch cost is microseconds per caption —
no Java round trip in the RL step (sampling on the device, reward on host).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _ngram_counts(tokens: Sequence[str], n_max: int = 4) -> Dict[Tuple, int]:
    counts: Dict[Tuple, int] = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def cook_refs(refs: Sequence[str], n: int = 4):
    return [_ngram_counts(ref.split(), n) for ref in refs]


def cook_test(test: str, n: int = 4):
    return _ngram_counts(test.split(), n)


class CiderScorer:
    """CIDEr-D over a corpus; document frequency from refs (or precomputed)."""

    def __init__(self, n: int = 4, sigma: float = 6.0,
                 df_corpus: Optional[Sequence[Sequence[str]]] = None):
        self.n = n
        self.sigma = sigma
        self.doc_frequency: Optional[Dict[Tuple, float]] = None
        self.ref_len: Optional[float] = None
        self._ref_vec_cache: Dict[str, tuple] = {}
        if df_corpus is not None:
            self.precompute_df(df_corpus)

    def precompute_df(self, refs_per_image: Sequence[Sequence[str]]):
        """refs_per_image: list (per image) of reference caption strings."""
        self._ref_vec_cache = {}   # vectors depend on df — invalidate
        self.doc_frequency = defaultdict(float)
        for refs in refs_per_image:
            for ngram in set(ng for ref in refs
                             for ng in _ngram_counts(ref.split(), self.n)):
                self.doc_frequency[ngram] += 1
        self.ref_len = math.log(float(len(refs_per_image)))

    def _counts2vec(self, cnts, df, ref_len):
        vec = [defaultdict(float) for _ in range(self.n)]
        length = 0
        norm = [0.0] * self.n
        for ngram, term_freq in cnts.items():
            d = math.log(max(1.0, df[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (ref_len - d)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += term_freq
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vec_h, vec_r, norm_h, norm_r, len_h, len_r):
        delta = float(len_h - len_r)
        gauss = math.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
        val = np.zeros(self.n)
        for k in range(self.n):
            vrk = vec_r[k]
            acc = 0.0
            for ngram, h in vec_h[k].items():
                # .get avoids defaultdict insertion; a missing/zero ref
                # term contributes exactly 0.0 — skipping it is value-exact
                r = vrk.get(ngram, 0.0)
                if r:
                    acc += min(h, r) * r
            if norm_h[k] != 0 and norm_r[k] != 0:
                acc /= norm_h[k] * norm_r[k]
            val[k] = acc * gauss
        return val

    def _cook_gts(self, gts: Dict, keys):
        """One pass over the references: per-ref ngram counts, the df (when
        not precomputed), and each ref's tf-idf vector — shared by every
        hypothesis set scored against these gts (compute/compute_pair).

        With a PRECOMPUTED df (the corpus-df mode the SCST reward uses,
        ref train.py:67) a ref string's vector is a pure function of the
        string, so it is memoized across calls — the RL loop rescores the
        same GT captions every epoch."""
        if self.doc_frequency is not None:
            df, ref_len = self.doc_frequency, self.ref_len
            cache = self._ref_vec_cache
            if len(cache) > (1 << 21):   # bound: ~2M refs ≫ any corpus here
                cache.clear()
            ref_vecs = {}
            for k in keys:
                out = []
                for ref in gts[k]:
                    v = cache.get(ref)
                    if v is None:
                        v = self._counts2vec(
                            _ngram_counts(ref.split(), self.n), df, ref_len)
                        cache[ref] = v
                    out.append(v)
                ref_vecs[k] = out
            return df, ref_len, ref_vecs
        ref_cnts = {k: [_ngram_counts(ref.split(), self.n)
                        for ref in gts[k]] for k in keys}
        df = defaultdict(float)
        for k in keys:
            for ngram in set(ng for cnts in ref_cnts[k] for ng in cnts):
                df[ngram] += 1
        ref_len = math.log(float(len(keys))) if keys else 0.0
        ref_vecs = {k: [self._counts2vec(c, df, ref_len)
                        for c in ref_cnts[k]] for k in keys}
        return df, ref_len, ref_vecs

    def _score_against(self, gts, res, keys, df, ref_len, ref_vecs):
        scores = np.zeros(len(keys))
        for i, k in enumerate(keys):
            test = res[k][0] if isinstance(res[k], (list, tuple)) else res[k]
            vec_h, norm_h, len_h = self._counts2vec(
                cook_test(test, self.n), df, ref_len)
            score = np.zeros(self.n)
            for (vec_r, norm_r, len_r) in ref_vecs[k]:
                score += self._sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r)
            scores[i] = np.mean(score / len(gts[k])) * 10.0
        return scores

    def compute(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        """gts/res: {key: [caption strings]} (res: single-item lists).

        Returns (corpus mean score, per-image scores).
        """
        keys = list(gts.keys())
        df, ref_len, ref_vecs = self._cook_gts(gts, keys)
        scores = self._score_against(gts, res, keys, df, ref_len, ref_vecs)
        return float(np.mean(scores)) if keys else 0.0, scores

    def compute_pair(self, gts: Dict, res_a: Dict, res_b: Dict):
        """Score TWO hypothesis sets against the same gts, cooking the
        references (df + tf-idf vectors) once — the SCST reward scores the
        sampled and baseline decodes against identical GTs every step, and
        ref cooking is ~half the reward's host time in the JAX package's
        measurements. Bit-identical to two compute() calls."""
        keys = list(gts.keys())
        df, ref_len, ref_vecs = self._cook_gts(gts, keys)
        return (self._score_against(gts, res_a, keys, df, ref_len, ref_vecs),
                self._score_against(gts, res_b, keys, df, ref_len, ref_vecs))


class Cider:
    """speaksee/pycocoevalcap-compatible facade."""

    def __init__(self, gts: Optional[Dict] = None, n: int = 4,
                 sigma: float = 6.0):
        df_corpus = None
        if gts is not None:
            if isinstance(gts, dict):
                df_corpus = list(gts.values())
            else:
                df_corpus = [g if isinstance(g, (list, tuple)) else [g]
                             for g in gts]
        self.scorer = CiderScorer(n=n, sigma=sigma, df_corpus=df_corpus)

    def compute_score(self, gts, res):
        if not isinstance(gts, dict):
            gts = {i: (g if isinstance(g, (list, tuple)) else [g])
                   for i, g in enumerate(gts)}
            res = {i: (r if isinstance(r, (list, tuple)) else [r])
                   for i, r in enumerate(res)}
        mean, per_image = self.scorer.compute(gts, res)
        return mean, per_image

    def compute_score_pair(self, gts, res_a, res_b):
        """Per-image scores for two hypothesis sets vs one gts, cooking the
        references once (bit-identical to two compute_score calls)."""
        if not isinstance(gts, dict):   # same normalization as compute_score
            gts = {i: (g if isinstance(g, (list, tuple)) else [g])
                   for i, g in enumerate(gts)}
            res_a = {i: (r if isinstance(r, (list, tuple)) else [r])
                     for i, r in enumerate(res_a)}
            res_b = {i: (r if isinstance(r, (list, tuple)) else [r])
                     for i, r in enumerate(res_b)}
        return self.scorer.compute_pair(gts, res_a, res_b)
