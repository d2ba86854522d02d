"""Vocabulary + text field with speaksee/torchtext-compatible semantics.

A copy of `vsrcic_tpu/text/vocab.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

The reference delegates caption preprocessing to the external `speaksee`
package (reference coco_scripts/train.py:1,43: TextField(init_token='<bos>',
eos_token='<eos>', lower=True, remove_punctuation=True, fix_length=20) and
text_field.build_vocab(..., min_freq=5)). Since vocab indices are baked into
the released checkpoints, this module reproduces those semantics natively:

  * tokenization: whitespace split after lowercasing, punctuation tokens
    dropped (speaksee's TextField.punctuations list)
  * vocab: itos = ['<unk>', '<pad>', init, eos] + corpus tokens filtered by
    min_freq, ordered by frequency desc with alphabetical tie-break
    (torchtext Vocab ordering)
  * numericalize: <bos> caption <eos> padded with <pad> to fix_length
  * decode: itos lookup, truncated at the first eos token
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

# speaksee.data.field.TextField.punctuations
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

UNK = "<unk>"
PAD = "<pad>"


class Vocab:
    """torchtext-style Vocab: specials first, then freq-desc / alpha ties."""

    def __init__(self, counter: Counter, specials: Sequence[str],
                 min_freq: int = 1):
        self.freqs = counter
        counter = counter.copy()
        for tok in specials:
            del counter[tok]
        self.itos: List[str] = list(specials)
        words_and_freqs = sorted(counter.items(), key=lambda tup: tup[0])
        words_and_freqs.sort(key=lambda tup: tup[1], reverse=True)
        for word, freq in words_and_freqs:
            if freq < min_freq:
                break
            self.itos.append(word)
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}

    def __len__(self):
        return len(self.itos)

    def __getitem__(self, token: str) -> int:
        return self.stoi.get(token, self.stoi.get(UNK, 0))


class TextField:
    """Caption preprocessing, numericalization and decoding."""

    punctuations = PUNCTUATIONS

    def __init__(self, init_token: str = "<bos>", eos_token: str = "<eos>",
                 lower: bool = True, remove_punctuation: bool = True,
                 fix_length: Optional[int] = 20):
        self.init_token = init_token
        self.eos_token = eos_token
        self.lower = lower
        self.remove_punctuation = remove_punctuation
        self.fix_length = fix_length
        self.vocab: Optional[Vocab] = None

    # -- preprocessing ------------------------------------------------------
    def preprocess(self, caption: str) -> List[str]:
        s = caption.rstrip("\n")
        if self.lower:
            s = s.lower()
        toks = s.split()
        if self.remove_punctuation:
            toks = [t for t in toks if t not in self.punctuations]
        return toks

    # -- vocab --------------------------------------------------------------
    def build_vocab(self, *caption_sources: Iterable[str], min_freq: int = 1):
        counter: Counter = Counter()
        for source in caption_sources:
            for cap in source:
                counter.update(self.preprocess(cap) if isinstance(cap, str)
                               else cap)
        specials = [UNK, PAD, self.init_token, self.eos_token]
        self.vocab = Vocab(counter, specials, min_freq=min_freq)
        return self.vocab

    @property
    def bos_idx(self) -> int:
        return self.vocab.stoi[self.init_token]

    @property
    def eos_idx(self) -> int:
        return self.vocab.stoi[self.eos_token]

    @property
    def pad_idx(self) -> int:
        return self.vocab.stoi[PAD]

    # -- numericalize -------------------------------------------------------
    def process(self, captions: Sequence[Union[str, List[str]]]) -> np.ndarray:
        """Captions -> (B, fix_length) int32: <bos> w... <eos> <pad>*."""
        assert self.vocab is not None, "build_vocab first"
        max_words = self.fix_length - 2  # room for bos/eos
        out = np.full((len(captions), self.fix_length), self.pad_idx, np.int32)
        for i, cap in enumerate(captions):
            toks = self.preprocess(cap) if isinstance(cap, str) else list(cap)
            toks = toks[:max_words]
            ids = [self.bos_idx] + [self.vocab[t] for t in toks] + [self.eos_idx]
            out[i, :len(ids)] = ids
        return out

    # -- decode -------------------------------------------------------------
    def decode(self, word_idxs, join_words: bool = True):
        """ids -> words, truncated at the first eos (speaksee decode parity).

        Accepts (T,) or (B, T) or deeper; returns nested lists/strings.
        """
        arr = np.asarray(word_idxs)
        if arr.ndim == 1:
            words = []
            for wi in arr:
                word = self.vocab.itos[int(wi)]
                if word == self.eos_token:
                    break
                words.append(word)
            return " ".join(words) if join_words else words
        return [self.decode(row, join_words=join_words) for row in arr]


def dedup_join(words: Sequence[str]) -> str:
    """' '.join(k for k, g in groupby(words)) — the scripts' repeat-dedup
    applied to decoded captions (reference coco_scripts/train.py:135,161)."""
    from itertools import groupby
    return " ".join(k for k, _ in groupby(words))
