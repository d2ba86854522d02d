"""Native METEOR (exact + stem stages, paraphrase via optional table).

A copy of `vsrcic_tpu/metrics/meteor.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

The reference scores METEOR through speaksee's bundled ``meteor-1.5.jar``
(ref coco_scripts/eval_coco.py:277, flickr_scripts/eval_flickr.py:284) —
a Java dependency this project replaces natively so the full metric table
can be produced without external provisioning.  This module implements the
METEOR 1.5 scoring model (Denkowski & Lavie 2014) with the English default
parameters the jar uses:

    alpha=0.85, beta=0.2, gamma=0.6;  module weights exact=1.0, stem=0.6,
    paraphrase=0.6 (synonym stage weight 0.8 — see divergences).

Scoring (per hyp/ref pair, identical formulas to Scorer.java):
    P      = weighted matched hyp words / hyp length
    R      = weighted matched ref words / ref length
    Fmean  = P*R / (alpha*P + (1-alpha)*R)
    frag   = chunks / ((m_hyp + m_ref) / 2)
    score  = (1 - gamma * frag**beta) * Fmean
Multi-reference takes the best-scoring reference; the corpus score sums the
best pair's sufficient statistics over segments and applies the same
formulas to the sums (the jar's aggregate "Final score", which is NOT the
mean of segment scores).

DOCUMENTED DIVERGENCES from meteor-1.5.jar (each is a missing *resource*,
not a formula change):
  * synonym stage: requires WordNet, which needs a corpus download this
    environment cannot perform — stage skipped (scores are a lower bound
    on the jar's; on COCO captions the stem stage covers most inflection).
  * paraphrase stage: the jar ships ``paraphrase-en.gz``; here the stage
    runs only when a table is provided via ``VSRCIC_METEOR_PARAPHRASES``
    (tab-separated ``phrase<TAB>phrase`` lines, optionally gzip).
  * function-word weighting (delta): the jar ships a corpus-derived
    ``function.words`` list; with no list every word is a content word and
    delta cancels out of P and R exactly, so it is omitted.
  * aligner: matches the jar's objective — the one-to-one unigram
    alignment maximizing total matches, then minimizing chunks, then
    maximizing module weight (exact over stem), then minimizing total
    |i-j| distance — via a beam search over hypothesis positions (width
    64). Fuzzed against a brute-force oracle on adversarial word orders:
    the score-relevant stats (matches, chunks, weight) are exactly
    optimal on every draw; under pruning the final distance tiebreak may
    select a different but score-identical alignment
    (tests/test_meteor.py::test_aligner_matches_bruteforce_oracle).
    Unambiguous alignments (no competing occurrences) take a forced
    fast path.

The stem stage uses NLTK's SnowballStemmer("english") — the *same*
algorithm (Porter2/"english" Snowball) as the jar's
``org.tartarus.snowball.ext.englishStemmer``, so stem matches are
jar-identical.

API mirrors the other metrics: ``compute_score(gts, res) -> (float,
np.ndarray)`` over PTB-tokenized caption dicts.  The eval CLI prefers the
real jar when ``VSRCIC_METEOR_JAR`` is set (metrics/external.py) and falls
back to this module, labeling the row ``METEOR(native)``.
"""
from __future__ import annotations

import functools
import gzip
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
W_EXACT = 1.0
W_STEM = 0.6
W_PARA = 0.6

_STEMMER = None


@functools.lru_cache(maxsize=1 << 17)
def _stem(word: str) -> str:
    global _STEMMER
    if _STEMMER is None:
        from nltk.stem import SnowballStemmer
        _STEMMER = SnowballStemmer("english")
    return _STEMMER.stem(word)


def load_paraphrase_table(path: str) -> Dict[Tuple[str, ...], set]:
    """``phrase<TAB>phrase`` lines -> symmetric phrase->phrases map."""
    table: Dict[Tuple[str, ...], set] = {}
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            a = tuple(parts[0].split())
            b = tuple(parts[1].split())
            if not a or not b:
                continue
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
    return table


def _unigram_candidates(hyp: List[str], ref: List[str]
                        ) -> List[List[Tuple[int, float]]]:
    """Per hyp position, the ref positions it may link to: exact matches
    at W_EXACT, else Snowball-stem matches at W_STEM (the jar assigns
    each word pair its highest-weight matching module)."""
    ref_st = [_stem(w) for w in ref]
    cand: List[List[Tuple[int, float]]] = []
    for w in hyp:
        links = []
        ws = _stem(w)
        for j, rw in enumerate(ref):
            if w == rw:
                links.append((j, W_EXACT))
            elif ws == ref_st[j]:
                links.append((j, W_STEM))
        cand.append(links)
    return cand


_BEAM = 64


def _search_unigram_alignment(hyp: List[str], ref: List[str]
                              ) -> List[Tuple[int, int, float]]:
    """Jar-objective one-to-one unigram alignment: maximize matches, then
    minimize chunks, then maximize total module weight, then minimize
    total |i-j| (meteor-1.5 Aligner resolution order).

    Beam search over hyp positions; a state is (ref-used bitmask, last
    linked (i, j)) scored by the partial objective. Alignments with no
    competing occurrences are forced and skip the search."""
    cand = _unigram_candidates(hyp, ref)

    # fast path: every hyp word has <=1 candidate and no ref position is
    # wanted twice -> the alignment is forced
    want: Dict[int, int] = {}
    forced = True
    for links in cand:
        if len(links) > 1:
            forced = False
            break
        for j, _ in links:
            want[j] = want.get(j, 0) + 1
            if want[j] > 1:
                forced = False
        if not forced:
            break
    if forced:
        return [(i, links[0][0], links[0][1])
                for i, links in enumerate(cand) if links]

    # state: (mask, last_i, last_j) -> (matches, -chunks, weight, -dist,
    #                                   pairs)
    start = (0, -9, -9)
    states = {start: (0, 0, 0.0, 0, ())}
    for i, links in enumerate(cand):
        nxt: Dict[Tuple[int, int, int],
                  Tuple[int, int, float, int, tuple]] = {}

        def consider(key, val):
            cur = nxt.get(key)
            if cur is None or val[:4] > cur[:4]:
                nxt[key] = val

        for (mask, li, lj), (m, nc, w, nd, pairs) in states.items():
            consider((mask, li, lj), (m, nc, w, nd, pairs))   # skip word i
            for j, wt in links:
                if mask >> j & 1:
                    continue
                new_chunk = not (li == i - 1 and lj == j - 1)
                consider((mask | 1 << j, i, j),
                         (m + 1, nc - (1 if new_chunk else 0), w + wt,
                          nd - abs(i - j), pairs + ((i, j, wt),)))
        if len(nxt) > _BEAM:
            states = dict(sorted(nxt.items(), key=lambda kv: kv[1][:4],
                                 reverse=True)[:_BEAM])
        else:
            states = nxt
    best = max(states.values(), key=lambda v: v[:4])
    return list(best[4])


def _phrase_spans(words: Sequence[str], used: List[bool],
                  table: Dict[Tuple[str, ...], set], max_len: int = 4):
    """Unused maximal phrase spans present in the table, longest-first."""
    spans = []
    n = len(words)
    for ln in range(max_len, 0, -1):
        for s in range(0, n - ln + 1):
            if any(used[s:s + ln]):
                continue
            ph = tuple(words[s:s + ln])
            if ph in table:
                spans.append((s, ln, ph))
    return spans


def _align(hyp: List[str], ref: List[str],
           para: Optional[Dict[Tuple[str, ...], set]]):
    """Align hyp/ref; returns (m_hyp, m_ref, wm_hyp, wm_ref, chunks).

    pairs are (hyp_pos, ref_pos, weight) unigram links; phrase (paraphrase)
    matches contribute one link per covered word so chunk computation sees
    the span as contiguous coverage.
    """
    hyp_used = [False] * len(hyp)
    ref_used = [False] * len(ref)
    pairs: List[Tuple[int, int, float]] = list(
        _search_unigram_alignment(list(hyp), list(ref)))
    for (i, j, _) in pairs:
        hyp_used[i] = True
        ref_used[j] = True

    if para:
        # greedy longest-first non-overlapping phrase pairs
        for (hs, hl, hph) in _phrase_spans(hyp, hyp_used, para):
            if any(hyp_used[hs:hs + hl]):
                continue
            tgts = para.get(hph, ())
            hit = None
            for (rs, rl, rph) in _phrase_spans(ref, ref_used, para):
                if rph in tgts and not any(ref_used[rs:rs + rl]):
                    hit = (rs, rl)
                    break
            if hit is None:
                continue
            rs, rl = hit
            for d in range(hl):
                hyp_used[hs + d] = True
            for d in range(rl):
                ref_used[rs + d] = True
            # one link per covered hyp word; ref positions walk the span
            for d in range(hl):
                pairs.append((hs + d, rs + min(d, rl - 1), W_PARA))
            # uncovered extra ref words count as matched ref mass
            for d in range(hl, rl):
                pairs.append((hs + hl - 1, rs + d, W_PARA))

    m_hyp = sum(hyp_used)
    m_ref = sum(ref_used)
    wm_hyp = 0.0
    wm_ref = 0.0
    seen_h = set()
    seen_r = set()
    for (i, j, w) in pairs:
        if i not in seen_h:
            wm_hyp += w
            seen_h.add(i)
        if j not in seen_r:
            wm_ref += w
            seen_r.add(j)

    # chunks: runs of links contiguous and monotone in BOTH strings; a
    # step of 0 on one side (many-to-one phrase links) continues the run
    chunks = 0
    ordered = sorted(set((i, j) for (i, j, _) in pairs))
    prev = None
    for (i, j) in ordered:
        cont = (prev is not None and i - prev[0] in (0, 1)
                and j - prev[1] in (0, 1) and (i, j) != prev)
        if not cont:
            chunks += 1
        prev = (i, j)
    # jar special case: a single chunk covering BOTH strings entirely pays
    # no fragmentation penalty (identical strings score exactly Fmean = 1)
    if chunks == 1 and m_hyp == len(hyp) and m_ref == len(ref):
        chunks = 0
    return m_hyp, m_ref, wm_hyp, wm_ref, chunks


def _score_from_stats(m_hyp, m_ref, wm_hyp, wm_ref, chunks,
                      len_hyp, len_ref) -> float:
    if m_hyp == 0 or m_ref == 0 or len_hyp == 0 or len_ref == 0:
        return 0.0
    p = wm_hyp / len_hyp
    r = wm_ref / len_ref
    if p == 0.0 or r == 0.0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
    frag = chunks / ((m_hyp + m_ref) / 2.0)
    return (1.0 - GAMMA * frag ** BETA) * fmean


class NativeMeteor:
    """METEOR scorer, speaksee-compatible API (compute_score(gts, res)).

    Raises ImportError at construction when nltk (the Snowball stemmer)
    is unavailable, so CLI fallbacks can degrade to an explicit
    'unavailable' row instead of crashing mid-epoch."""

    def __init__(self, paraphrase_table: Optional[str] = None):
        _stem("initialization")   # fail fast if nltk is missing
        path = paraphrase_table or os.environ.get("VSRCIC_METEOR_PARAPHRASES")
        self.para = (load_paraphrase_table(path)
                     if path and os.path.isfile(path) else None)

    def sentence_stats(self, hyp: str, refs: Sequence[str]):
        """Best-reference sufficient statistics for one segment."""
        h = hyp.split()
        best = None
        for ref in refs:
            r = ref.split()
            st = _align(h, r, self.para)
            sc = _score_from_stats(*st, len(h), len(r))
            if best is None or sc > best[0]:
                best = (sc, st + (len(h), len(r)))
        if best is None:                      # no references for this key
            best = (0.0, (0, 0, 0.0, 0.0, 0, len(h), 0))
        return best

    def compute_score(self, gts: Dict, res: Dict):
        keys = list(gts.keys())
        seg = np.zeros(len(keys))
        agg = np.zeros(7)
        for n, k in enumerate(keys):
            hyp = res[k][0] if isinstance(res[k], (list, tuple)) else res[k]
            sc, st = self.sentence_stats(hyp, gts[k])
            seg[n] = sc
            agg += np.asarray(st, dtype=float)
        final = _score_from_stats(agg[0], agg[1], agg[2], agg[3], agg[4],
                                  agg[5], agg[6])
        return float(final), seg
