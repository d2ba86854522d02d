"""ctypes bindings for the native packed-store batch reader
(`csrc/packed_reader.cpp`).

Counterpart of `vsrcic_tpu/data/native_reader.py`, over the port's own copy
of the C++ source, which `ops/_build.py::host_library` compiles with the
host C++ compiler at first use into `vsrcic_tpu_torch/build/`, as it does
the CIDEr-D scorer.

`batch_features(store, ids, max_rows)` gathers a padded (B, max_rows, D)
feature batch with multithreaded C++ memcpy. This is the replacement for
the reference's per-item h5py reads in DataLoader workers (SURVEY.md §2.4).

Unlike the JAX package's bridge, a reader that does not build or load
raises; `fill_padded_batch_plain` is the numpy version the tests hold the
native one to, not a fall back. A bf16 store's batch is gathered as raw
bits and widened to f32 after the copy (`data/store.py`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from vsrcic_tpu_torch.data.store import BF16_BITS, bf16_bits_to_f32
from vsrcic_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    """The reader library, built first if needed; raises if it cannot be
    built or loaded."""
    lib = ctypes.CDLL(str(_build.host_library("packed_reader")))
    lib.fill_padded_batch_f32.restype = None
    lib.fill_padded_batch_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.gather_rows_f32.restype = None
    lib.gather_rows_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    return lib


def native_available() -> bool:
    """Whether the reader builds and loads here."""
    try:
        _load_lib()
    except (OSError, RuntimeError):
        return False
    return True


def _ranges(src, starts, counts, max_rows):
    """starts/counts as int64 arrays; raises ValueError where a range (of
    at most max_rows rows, as many as are copied) lies outside src."""
    starts_a = np.ascontiguousarray(starts, np.int64)
    counts_a = np.ascontiguousarray(counts, np.int64)
    if len(starts_a) != len(counts_a):
        raise ValueError("starts and counts differ in length: %d != %d"
                         % (len(starts_a), len(counts_a)))
    read = np.minimum(counts_a, max_rows)
    if len(starts_a) and ((starts_a < 0).any() or (counts_a < 0).any()
                          or (starts_a + read > src.shape[0]).any()):
        raise ValueError("a row range lies outside the source's %d rows"
                         % src.shape[0])
    return starts_a, counts_a


def fill_padded_batch(src: np.ndarray, starts: Sequence[int],
                      counts: Sequence[int], max_rows: int,
                      nthreads: int = 4) -> np.ndarray:
    """src: (total_rows, D) f32, or 2-byte (a bf16 store's bits) with D
    even (memmap ok) -> (B, max_rows, D) in src's dtype, zero padded.

    2-byte rows ride the same C++ memcpy kernel through a byte view: a
    (rows, D) 2-byte array IS a (rows, D/2) f32 array to memcpy."""
    dim = src.shape[1]
    if src.dtype == np.float32:
        words = dim
    elif src.dtype.itemsize == 2 and dim % 2 == 0:
        words = dim // 2
    else:
        raise ValueError("the native reader copies f32 rows or 2-byte rows "
                         "of even width; got %s of width %d"
                         % (src.dtype, dim))
    if not src.flags.c_contiguous:
        raise ValueError("the native reader needs a C-contiguous source")
    starts_a, counts_a = _ranges(src, starts, counts, max_rows)
    n = len(starts_a)
    out = np.empty((n, max_rows, dim), src.dtype)
    _load_lib().fill_padded_batch_f32(
        src.ctypes.data, words, starts_a.ctypes.data, counts_a.ctypes.data,
        n, max_rows, out.ctypes.data, nthreads)
    return out


def fill_padded_batch_plain(src: np.ndarray, starts: Sequence[int],
                            counts: Sequence[int],
                            max_rows: int) -> np.ndarray:
    """The numpy version of `fill_padded_batch` (the JAX package's
    fallback loop)."""
    starts_a, counts_a = _ranges(src, starts, counts, max_rows)
    out = np.zeros((len(starts_a), max_rows, src.shape[1]), src.dtype)
    for i, (s, c) in enumerate(zip(starts_a, counts_a)):
        c = min(int(c), max_rows)
        out[i, :c] = src[int(s):int(s) + c]
    return out


def batch_features(store, image_ids: Sequence, max_rows: int = 100,
                   nthreads: int = 4) -> np.ndarray:
    """Padded f32 feature batch straight from a PackedFeatureStore's
    memmap (a bf16 store's batch widened after the copy)."""
    starts, counts = [], []
    for i in image_ids:
        s, c = store.index[str(i)]
        starts.append(s)
        counts.append(c)
    out = fill_padded_batch(store._feat, starts, counts, max_rows,
                            nthreads=nthreads)
    return bf16_bits_to_f32(out) if store.dtype == BF16_BITS else out
