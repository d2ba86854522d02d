"""Native PTB-style tokenizer.

A copy of `vsrcic_tpu/text/tokenizer.py` (`re` only): the port imports
nothing of the JAX package, not even its JAX-free modules.

The reference shells out to the Stanford CoreNLP PTBTokenizer *jar* for every
RL step and at eval (reference coco_scripts/train.py:165-167,
eval_coco.py:269-270 via speaksee.evaluation.PTBTokenizer) — a
GPU->CPU->Java round trip in the SCST hot loop. This is a pure-Python
implementation of the classic Penn Treebank tokenization rules (the public
`tokenizer.sed` rules, same lineage as nltk's TreebankWordTokenizer) followed
by the coco-caption post-processing: lowercase + drop punctuation tokens.

For generated captions (already lowercase, punctuation-free vocab words) this
is exact; for GT captions it reproduces the jar's behavior on the ~all of the
corpus that exercises the standard rules.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Sequence, Union

# coco-caption PTBTokenizer PUNCTUATIONS
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(PUNCTUATIONS)

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])\""), r"\1 `` "),
]
_PUNCT_RULES = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = [
    (re.compile(r"\("), " -LRB- "), (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "), (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "), (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"--"), " -- "),
]
_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS = [
    re.compile(r"\b(can)(not)\b", re.IGNORECASE),
    re.compile(r"\b(gon)(na)\b", re.IGNORECASE),
    re.compile(r"\b(got)(ta)\b", re.IGNORECASE),
    re.compile(r"\b(lem)(me)\b", re.IGNORECASE),
    re.compile(r"\b(wan)(na)\b", re.IGNORECASE),
]


def ptb_word_tokenize(text: str) -> List[str]:
    """Penn-Treebank word tokenization of one sentence."""
    for regexp, sub in _STARTING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp, sub in _PUNCT_RULES:
        text = regexp.sub(sub, text)
    for regexp, sub in _PARENS_BRACKETS:
        text = regexp.sub(sub, text)
    text = " " + text + " "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


@functools.lru_cache(maxsize=1 << 17)
def tok_one(s: str) -> str:
    # jar pipeline parity: the Stanford call tokenizes the ORIGINAL
    # text and lowercases the emitted tokens (-lowerCase), so bracket
    # tokens come out as "-lrb-"/"-rrb-" — which the coco-caption
    # PUNCTUATIONS membership test (uppercase "-LRB-") then FAILS to
    # drop. Lowercase after tokenization, not before, to reproduce
    # exactly that kept-bracket-token quirk (tests/test_ptb_golden.py).
    # Cached: the SCST reward re-tokenizes the same GT strings every
    # epoch (and model decodes repeat heavily) — str -> str, pure.
    words = (w.lower() for w in ptb_word_tokenize(s))
    return " ".join(w for w in words if w not in _PUNCT_SET)


def ptb_tokenize(captions: Union[Dict, Sequence]):
    """coco-caption PTBTokenizer.tokenize parity: tokenize the original
    text, lowercase the tokens, drop punctuation tokens, join with spaces.

    Tokenize-then-lowercase order matters: it is what keeps the jar's
    ``-lrb-``/``-rrb-`` bracket tokens (pinned in tests/test_ptb_golden.py).

    Accepts {key: [caption strings]} -> {key: [tokenized strings]}, or a
    sequence of caption-lists / strings with the same nesting preserved
    (speaksee also accepts list-of-lists).
    """
    if isinstance(captions, dict):
        return {k: [tok_one(c) for c in v] for k, v in captions.items()}
    out = []
    for item in captions:
        if isinstance(item, str):
            out.append(tok_one(item))
        else:
            out.append([tok_one(c) for c in item])
    return out
