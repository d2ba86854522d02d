"""Detection-feature stores.

The reference opens the HDF5 detections file *per example inside DataLoader
workers* (reference data/field.py:70-73,138-141 — a fresh `h5py.File` per
item) — the dominant input-pipeline cost. Here stores are an explicit
abstraction:

  * `HDF5FeatureStore` — compat reader for the original
    `coco_detections.hdf5` / `flickr30k_detections.hdf5` files (one persistent
    handle, not per-item opens), including the reference's missing-key
    fallback to random features (field.py:74-78).
  * `PackedFeatureStore` — one-time conversion to a flat memmap (features,
    cls_probs, boxes concatenated + an offsets index). Zero-copy reads, no
    HDF5 chunk decoding; the C++ prefetch reader (csrc/packed_reader.cpp)
    mmaps the same format.
  * `SyntheticFeatureStore` — deterministic per-id fabricated detections;
    formalizes the reference's accidental "runs without data" affordance
    (SURVEY.md §4) as a first-class backend for tests and benchmarks.

All stores return `DetRecord(cls_probs (N, C), features (N, D), boxes (N, 4))`.

A copy of `vsrcic_tpu/data/store.py` (numpy only), with one change: bf16 at
rest needs no `ml_dtypes`. A bf16 packed store is memmapped as its raw
`uint16` bits (`BF16_BITS`) and widened to f32 on the host wherever it is
read (`get`, and `native_reader.batch_features` after the native gather),
so every consumer sees f32 with the values JAX's widening gives: every bf16
value is exact in f32. Writing one (`convert_hdf5(..., dtype="bfloat16")`)
rounds f32 to nearest even, as `ml_dtypes` does.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import NamedTuple, Union

import numpy as np


class DetRecord(NamedTuple):
    cls_probs: np.ndarray
    features: np.ndarray
    boxes: np.ndarray


# the at-rest dtype of a bf16 packed store: its raw bits
BF16_BITS = np.dtype(np.uint16)


def packed_dtype(name) -> np.dtype:
    """Resolve a packed-store dtype name; 'bfloat16' maps to `BF16_BITS`
    (numpy has no bf16). bf16-at-rest halves the memcpy bytes of the
    ingest gather, the dominant cost on a memory-bound loader host."""
    if str(name) in ("bfloat16", "bf16"):
        return BF16_BITS
    return np.dtype(name)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bf16 bits (uint16) -> the same values in f32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> raw bf16 bits, rounded to nearest even; NaN stays a quiet
    NaN of the same sign."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    out[nan] = ((u[nan] >> 16) | 0x0040).astype(np.uint16)
    return out


class HDF5FeatureStore:
    def __init__(self, path: str):
        import h5py
        self.path = path
        self._f = h5py.File(path, "r")

    def get(self, image_id: Union[int, str]) -> DetRecord:
        try:
            return DetRecord(
                self._f["%s_cls_prob" % image_id][()],
                self._f["%s_features" % image_id][()],
                self._f["%s_boxes" % image_id][()],
            )
        except KeyError:
            warnings.warn("Could not find detections for %s" % image_id)
            # reference fallback shape quirk preserved (field.py:76-78)
            return DetRecord(np.random.rand(10, 2048),
                             np.random.rand(10, 2048),
                             np.random.rand(10, 4))

    @staticmethod
    def _base_id(key: str) -> str:
        for suffix in ("_cls_prob", "_features", "_boxes"):
            if key.endswith(suffix):
                return key[: -len(suffix)]
        return key

    def keys(self):
        seen = set()
        for k in self._f.keys():
            base = self._base_id(k)
            if base not in seen:
                seen.add(base)
                yield base


class PackedFeatureStore:
    """Flat little-endian memmap store: index.json + {features,cls_probs,boxes}.bin."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "index.json")) as f:
            meta = json.load(f)
        self.index = meta["index"]          # {id: [start_row, n_rows]}
        self.feat_dim = meta["feat_dim"]
        self.n_classes = meta["n_classes"]
        self.dtype = packed_dtype(meta.get("dtype", "float32"))
        n_total = meta["n_total_rows"]
        self._feat = np.memmap(os.path.join(root, "features.bin"),
                               self.dtype, "r", shape=(n_total, self.feat_dim))
        self._prob = np.memmap(os.path.join(root, "cls_probs.bin"),
                               self.dtype, "r", shape=(n_total, self.n_classes))
        self._box = np.memmap(os.path.join(root, "boxes.bin"),
                              np.float32, "r", shape=(n_total, 4))

    def get(self, image_id: Union[int, str]) -> DetRecord:
        key = str(image_id)
        if key not in self.index:
            warnings.warn("Could not find detections for %s" % image_id)
            return DetRecord(np.random.rand(10, 2048),
                             np.random.rand(10, 2048),
                             np.random.rand(10, 4))
        start, n = self.index[key]
        sl = slice(start, start + n)
        if self.dtype == BF16_BITS:
            # widen bf16 -> f32 (exact: every bf16 value is
            # f32-representable); the batched gather widens after the copy
            return DetRecord(bf16_bits_to_f32(self._prob[sl]),
                             bf16_bits_to_f32(self._feat[sl]),
                             np.asarray(self._box[sl]))
        return DetRecord(np.asarray(self._prob[sl]),
                         np.asarray(self._feat[sl]),
                         np.asarray(self._box[sl]))

    def keys(self):
        return iter(self.index.keys())

    @staticmethod
    def convert_hdf5(hdf5_path: str, out_root: str, dtype: str = "float32"):
        """One-time HDF5 -> packed conversion (replaces per-item file opens)."""
        import h5py
        os.makedirs(out_root, exist_ok=True)
        f = h5py.File(hdf5_path, "r")
        ids = sorted({HDF5FeatureStore._base_id(k) for k in f.keys()})
        index = {}
        rows = 0
        feat_dim = n_classes = None
        for i in ids:
            n = f["%s_features" % i].shape[0]
            if feat_dim is None:
                feat_dim = f["%s_features" % i].shape[1]
                n_classes = f["%s_cls_prob" % i].shape[1]
            index[i] = [rows, n]
            rows += n
        np_dtype = packed_dtype(dtype)
        feat = np.memmap(os.path.join(out_root, "features.bin"), np_dtype,
                         "w+", shape=(rows, feat_dim))
        prob = np.memmap(os.path.join(out_root, "cls_probs.bin"), np_dtype,
                         "w+", shape=(rows, n_classes))
        box = np.memmap(os.path.join(out_root, "boxes.bin"), np.float32,
                        "w+", shape=(rows, 4))
        cast = (f32_to_bf16_bits if np_dtype == BF16_BITS
                else (lambda a: a))
        for i in ids:
            s, n = index[i]
            feat[s:s + n] = cast(f["%s_features" % i][()])
            prob[s:s + n] = cast(f["%s_cls_prob" % i][()])
            box[s:s + n] = f["%s_boxes" % i][()]
        feat.flush(); prob.flush(); box.flush()
        with open(os.path.join(out_root, "index.json"), "w") as fp:
            json.dump({"index": index, "feat_dim": feat_dim,
                       "n_classes": n_classes, "n_total_rows": rows,
                       "dtype": dtype}, fp)
        return PackedFeatureStore(out_root)


class SyntheticFeatureStore:
    """Deterministic fabricated detections keyed by image id."""

    def __init__(self, feat_dim: int = 2048, n_classes: int = 1601,
                 n_dets: int = 10, seed: int = 0):
        self.feat_dim = feat_dim
        self.n_classes = n_classes
        self.n_dets = n_dets
        self.seed = seed

    def _rng(self, image_id):
        h = abs(hash((self.seed, str(image_id)))) % (2 ** 31)
        return np.random.RandomState(h)

    def get(self, image_id: Union[int, str]) -> DetRecord:
        rng = self._rng(image_id)
        n = self.n_dets
        probs = rng.rand(n, self.n_classes).astype(np.float32)
        feats = rng.rand(n, self.feat_dim).astype(np.float32)
        x1 = rng.rand(n, 1) * 300
        y1 = rng.rand(n, 1) * 300
        boxes = np.concatenate([x1, y1, x1 + 10 + rng.rand(n, 1) * 100,
                                y1 + 10 + rng.rand(n, 1) * 100], 1
                               ).astype(np.float32)
        return DetRecord(probs, feats, boxes)
