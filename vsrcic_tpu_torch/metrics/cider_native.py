"""ctypes bridge to the native CIDEr-D scorer (`csrc/cider_scorer.cpp`).

Counterpart of `vsrcic_tpu/metrics/cider_native.py`, over the port's own
`metrics/cider.py` and its own copy of the C++ source, which
`ops/_build.py::host_library` compiles with the host C++ compiler at first
use into `vsrcic_tpu_torch/build/`.

The SCST reward computes CIDEr inside every RL step (reference
coco_scripts/train.py:169-170). This scorer keeps the corpus
document-frequency table resident in C++ and scores the sampled and
baseline decodes from interned word-id arrays, on up to 16 threads.

Scope: the SCST configuration only: a corpus-precomputed df, one reference
per key, both hypothesis sets scored against the same references, the
default n=4 / sigma=6 CIDEr-D (construction checks all of this against the
paired Cider). Values match metrics/cider.py to float64 round-off; only the
order of the terms' summation differs.

Unlike the JAX package's bridge, a scorer that does not build or load
raises: with the knob on (`VSRCIC_NATIVE_CIDER`, default 1) the caller gets
the native scorer or an error, never a silent fall back to Python.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Sequence

import numpy as np

from vsrcic_tpu_torch.metrics.cider import Cider
from vsrcic_tpu_torch.ops import _build

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The scorer library, built first if needed; raises if it cannot be
    built or loaded."""
    lib = ctypes.CDLL(str(_build.host_library("cider_scorer")))
    lib.cider_new.restype = ctypes.c_void_p
    lib.cider_new.argtypes = [ctypes.c_double]
    lib.cider_free.restype = None
    lib.cider_free.argtypes = [ctypes.c_void_p]
    lib.cider_df_load_csr.restype = None
    lib.cider_df_load_csr.argtypes = [ctypes.c_void_p, _I32P, _I64P, _F64P,
                                      ctypes.c_int64]
    lib.cider_score_pair.restype = None
    lib.cider_score_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I32P, _I64P, _I32P, _I64P, _I32P,
        _I64P, _F64P, _F64P, ctypes.c_int]
    return lib


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def check_compatible(cider: Cider) -> None:
    """Raise ValueError unless `cider` is the configuration the native
    scorer implements: a corpus df and the default n=4 / sigma=6."""
    sc = cider.scorer
    if sc.doc_frequency is None:
        raise ValueError(
            "native CIDEr requires a corpus-df Cider (Cider(gts=...), ref "
            "train.py:67); per-batch-df mode stays on the Python scorer")
    if sc.n != 4 or sc.sigma != 6.0:
        raise ValueError("native CIDEr implements the default n=4/sigma=6 "
                         "CIDEr-D; got n=%d sigma=%s" % (sc.n, sc.sigma))


class NativeCiderPair:
    """Stateful corpus-df CIDEr-D pair scorer (the SCST reward's
    configuration).

    Build it from the same corpus-df Cider the trainer would score with:
    the df table is taken from it as it is and the parameters are checked,
    so the native and Python rewards cannot drift apart.
    """

    def __init__(self, cider: Cider):
        check_compatible(cider)
        sc = cider.scorer
        self._lib = _load()
        self._intern: Dict[str, int] = {}
        self._handle = ctypes.c_void_p(self._lib.cider_new(sc.ref_len))
        # the df table in CSR, loaded in one call
        ids: List[int] = []
        off = np.zeros(len(sc.doc_frequency) + 1, np.int64)
        vals = np.zeros(len(sc.doc_frequency), np.float64)
        for i, (ng, val) in enumerate(sc.doc_frequency.items()):
            ids.extend(self._wid(w) for w in ng)
            off[i + 1] = len(ids)
            vals[i] = val
        words = np.asarray(ids, np.int32)
        self._lib.cider_df_load_csr(self._handle, _ptr(words, _I32P),
                                    _ptr(off, _I64P), _ptr(vals, _F64P),
                                    len(vals))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.cider_free(handle)
            self._handle = None

    def _wid(self, w: str) -> int:
        i = self._intern.get(w)
        if i is None:
            i = len(self._intern)
            self._intern[w] = i
        return i

    def _pack(self, caps: Sequence[str]):
        ids: List[int] = []
        off = np.zeros(len(caps) + 1, np.int64)
        for i, c in enumerate(caps):
            ids.extend(self._wid(w) for w in c.split())
            off[i + 1] = len(ids)
        return np.asarray(ids, np.int32), off

    def score_pair(self, gt_caps: Sequence[str], a_caps: Sequence[str],
                   b_caps: Sequence[str]):
        """Per-image CIDEr-D (x10) of two hypothesis lists against one GT
        list (one reference per image, the SCST reward's shape)."""
        n = len(gt_caps)
        if len(a_caps) != n or len(b_caps) != n:
            # a ValueError, not an assert: mismatched CSR lengths would have
            # the C++ side read out of bounds
            raise ValueError("caption list lengths differ: gt=%d a=%d b=%d"
                             % (n, len(a_caps), len(b_caps)))
        gw, go = self._pack(gt_caps)
        aw, ao = self._pack(a_caps)
        bw, bo = self._pack(b_caps)
        out_a = np.zeros(n, np.float64)
        out_b = np.zeros(n, np.float64)
        self._lib.cider_score_pair(
            self._handle, n, _ptr(gw, _I32P), _ptr(go, _I64P),
            _ptr(aw, _I32P), _ptr(ao, _I64P), _ptr(bw, _I32P),
            _ptr(bo, _I64P), _ptr(out_a, _F64P), _ptr(out_b, _F64P),
            min(os.cpu_count() or 1, 16))
        return out_a, out_b


def maybe_native(cider: Cider, verbose: bool = True):
    """The shared opt-in: a NativeCiderPair for `cider` unless
    VSRCIC_NATIVE_CIDER is 0 or `cider` is a configuration the native
    scorer does not implement (then None: the caller keeps the Python
    scorer). A scorer that fails to build or load raises."""
    if not int(os.environ.get("VSRCIC_NATIVE_CIDER", "1")):
        return None
    try:
        check_compatible(cider)
    except ValueError:
        return None
    nat = NativeCiderPair(cider)
    if verbose:
        print("SCST reward: native C++ CIDEr scorer "
              "(VSRCIC_NATIVE_CIDER=0 for the Python path)")
    return nat


def available() -> bool:
    """Whether the scorer builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True
