"""GSRL-inference datasets (SURVEY.md D3/D4; reference data/dataset.py:305-478).

A copy of `vsrcic_tpu/data/gsrl.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

These serve the unreleased GSRL preprocessing pipeline (reference
README.md:43-45) — no in-repo script consumes them, but they are part of the
reference capability surface: per-image detection records + semantic-role
tables with collate functions that pad detections (50 for COCO / 56 for
Flickr) and, for COCO, pool per-class features into a 26 x feat_dim grid.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np



class NEWDataset:
    """COCO GSRL inference dataset (ref :305-354)."""

    def __init__(self, image_names: List[str], store,
                 img_idx_2_sr: Dict[str, Any], inference: bool = False,
                 inference_verbs: Optional[Dict[str, int]] = None,
                 is_training: bool = False):
        self.image_names = list(image_names)
        self.store = store
        self.inference = inference
        self.inference_verbs = inference_verbs or {}
        self.is_training = is_training
        self.img_idx_2_sr = img_idx_2_sr
        self.image_to_image_idx = {n: i for i, n in enumerate(self.image_names)}

    @classmethod
    def from_files(cls, train_file: str, store, sr_json: str, **kw):
        with open(train_file) as f:
            names = [line.rstrip("\n") for line in f]
        with open(sr_json) as f:
            sr = json.load(f)
        return cls(names, store, sr, **kw)

    def __len__(self):
        return len(self.image_names)

    def __getitem__(self, idx: int):
        name = self.image_names[idx]
        verb_idx = self.inference_verbs.get(name, 0)
        id_img = int(name.split("__")[0].split("_")[-1].split(".")[0])
        rec = self.store.get(id_img)
        return {"img_name": name, "verb_idx": verb_idx,
                "det_cls_probs": rec.cls_probs, "det_features": rec.features,
                "det_boxes": rec.boxes, "sr": self.img_idx_2_sr.get(name)}


def collater_new(data: List[Dict[str, Any]], max_dets: int = 50,
                 n_sr: int = 26, max_classes: int = 20):
    """COCO collate: pad to 50 dets + per-class pooled features (ref :357-403)."""
    batch_size = len(data)
    feat_dim = data[0]["det_features"].shape[-1]
    n_probs = data[0]["det_cls_probs"].shape[-1]
    det_features = np.zeros((batch_size, max_dets, feat_dim))
    det_cls_probs = np.zeros((batch_size, max_dets, n_probs))
    det_boxes = np.zeros((batch_size, max_dets, 4))
    for i, s in enumerate(data):
        m = min(max_dets, len(s["det_features"]))
        det_features[i, :m] = s["det_features"][:max_dets]
        det_cls_probs[i, :m] = s["det_cls_probs"][:max_dets]
        det_boxes[i, :m] = s["det_boxes"][:max_dets]

    det_classes = np.zeros((batch_size, n_sr))
    det_cls_feat = np.zeros((batch_size, n_sr, feat_dim))
    for i, s in enumerate(data):
        selected = [int(np.argmax(s["det_cls_probs"][j][1:])) + 1
                    for j in range(len(s["det_cls_probs"]))]
        cls_2_region: Dict[int, List[int]] = {}
        for j, cls_ in enumerate(selected):
            if j < max_dets:
                cls_2_region.setdefault(cls_, []).append(j)
        for j, cls_ in enumerate(cls_2_region):
            if j < max_classes:
                det_classes[i, j] = cls_
                det_cls_feat[i, j] = np.mean(
                    det_features[i, cls_2_region[cls_], :], axis=0)

    return {"img_name": [s["img_name"] for s in data],
            "verb_idx": np.asarray([s["verb_idx"] for s in data]),
            "det_cls_probs": det_cls_probs.astype(np.float32),
            "det_features": det_features.astype(np.float32),
            "det_classes": det_classes.astype(np.float32),
            "det_cls_feat": det_cls_feat.astype(np.float32),
            "det_boxes": det_boxes.astype(np.float32),
            "sr": [s["sr"] for s in data]}


class Dataset_Flickr(NEWDataset):
    """Flickr GSRL inference dataset (ref :406-452); string image ids."""

    def __getitem__(self, idx: int):
        name = self.image_names[idx]
        verb_idx = self.inference_verbs.get(name, 0)
        id_img = name.split("__")[0]
        rec = self.store.get(id_img)
        return {"img_name": name, "verb_idx": verb_idx,
                "det_cls_probs": rec.cls_probs, "det_features": rec.features,
                "det_boxes": rec.boxes, "sr": self.img_idx_2_sr.get(name)}


def collater_flickr(data: List[Dict[str, Any]], max_dets: int = 56):
    """Flickr collate: pad to 56 dets (ref :455-478)."""
    batch_size = len(data)
    feat_dim = data[0]["det_features"].shape[-1]
    n_probs = data[0]["det_cls_probs"].shape[-1]
    det_features = np.zeros((batch_size, max_dets, feat_dim))
    det_cls_probs = np.zeros((batch_size, max_dets, n_probs))
    det_boxes = np.zeros((batch_size, max_dets, 4))
    for i, s in enumerate(data):
        m = min(max_dets, len(s["det_features"]))
        det_features[i, :m] = s["det_features"][:max_dets]
        det_cls_probs[i, :m] = s["det_cls_probs"][:max_dets]
        det_boxes[i, :m] = s["det_boxes"][:max_dets]
    return {"img_name": [s["img_name"] for s in data],
            "verb_idx": np.asarray([s["verb_idx"] for s in data]),
            "det_cls_probs": det_cls_probs.astype(np.float32),
            "det_features": det_features.astype(np.float32),
            "det_boxes": det_boxes.astype(np.float32),
            "sr": [s["sr"] for s in data]}
