"""Control-set / detection field preprocessors.

A copy of `vsrcic_tpu/data/fields.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

Behavioral ports of every field in the reference data layer
(reference data/field.py:15-1389, components D5-D15 in SURVEY.md §2.2). Each
field turns one (image, caption, annotations) example into fixed-shape numpy
tensors; semantics — including the quirks that define training data and hence
checkpoint parity — are preserved exactly:

  * class-seeded region groups with optional box-containment expansion
    (ref :36-42)
  * shift-gate GT = 1 where consecutive word classes differ (ref :93-97)
  * position features with the reference's center formula `(x2 - x1/2)/w`
    (ref :256-259 — kept as-is, it defines the Sinkhorn input distribution)
  * alphabetical-sort permutation GT for COCOControlSetField (ref :241-244)
    vs random-shuffle GT for the *_Verb fields (ref :492-497)
  * Flickr verb ids encoded as `idx + 1 + 10000*occurrence` (ref :844-845)
  * missing-detection fallback to random features (ref :74-78)

Differences from the reference (deliberate, perf-only): detections come from a
`FeatureStore` (no per-item h5py.File opens) and side tables are loaded once
and shared; outputs are identical numpy arrays.
"""
from __future__ import annotations

import json
import pickle
import random
from itertools import groupby
from typing import Dict, List

import numpy as np


# ref data/field.py:187-189
SR_2_IDX = {"ARG0": 1, "ARG1": 2, "ARG2": 3, "ARG3": 4, "ARG4": 5, "ARG5": 6,
            "LOC": 7, "DIR": 8, "GOL": 9, "MNR": 10, "TMP": 11, "EXT": 12,
            "REC": 13, "PRD": 14, "PRP": 15, "CAU": 16, "DIS": 17, "ADV": 18,
            "ADJ": 19, "MOD": 20, "NEG": 21, "LVB": 22, "PNC": 23, "COM": 24,
            "V": 25}


def load_classes(classes_path: str) -> List[str]:
    classes = ["__background__"]
    with open(classes_path) as f:
        for line in f.readlines():
            classes.append(line.split(",")[0].lower().strip())
    return classes


def _load(arg, loader):
    """Accept a path (load it) or an already-loaded object (pass through)."""
    if isinstance(arg, str):
        return loader(arg)
    return arg


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def selected_classes_of(classes: List[str], cls_probs: np.ndarray) -> List[str]:
    """Per-detection class name = argmax over non-background probs (ref :83)."""
    return [classes[int(np.argmax(cls_probs[i][1:])) + 1]
            for i in range(len(cls_probs))]


def coco_image_id(image_path: str) -> int:
    return int(image_path.split("/")[-1].split("_")[-1].split(".")[0])


def flickr_image_id(image_path: str) -> str:
    return image_path.split("/")[-1].split(".")[0]


def box_position(bbox, width, height):
    """Normalized box geometry — reference formula preserved (ref :256-259)."""
    return np.array([
        (bbox[2] - bbox[0] / 2) / width,
        (bbox[3] - bbox[1] / 2) / height,
        (bbox[2] - bbox[0]) / width,
        (bbox[3] - bbox[1]) / height,
    ], np.float32)


class RawField:
    """speaksee-compatible passthrough field."""

    def __init__(self, preprocessing=None, postprocessing=None):
        self.preprocessing = preprocessing
        self.postprocessing = postprocessing

    def preprocess(self, x):
        return self.preprocessing(x) if self.preprocessing else x

    def process(self, batch):
        return self.postprocessing(batch) if self.postprocessing else batch


# ---------------------------------------------------------------------------
# D5: COCOControlSequenceField (captioner training control) — ref :15-110
# ---------------------------------------------------------------------------

class COCOControlSequenceField(RawField):
    """Captioner-training control field (ref :15-110).

    `compact=True` emits region-group *detection indices* `(fix_length,
    max_detections) int32` (−1 padded) instead of materialized `(fix_length,
    max_detections, 2048)` feature tensors — an ~8x smaller host->device
    payload; the decode/training scans gather the features on device from the
    image's detection tensor (exact same values; requires group det ids <
    the image field's max_detections, which holds for the released HDF5).
    """

    def __init__(self, store, classes_path=None, padding_idx=0,
                 fix_length=None, all_boxes=True, pad_eos=True,
                 max_detections=20, sorting=False, compact=False,
                 image_max_detections=100, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.max_detections = max_detections
        self.padding_idx = padding_idx
        self.fix_length = fix_length
        self.all_boxes = all_boxes
        self.sorting = sorting
        self.compact = compact
        # row budget of the companion ImageDetectionsField: compact ids index
        # into that field's padded/truncated detection tensor, so ids >= its
        # max_detections would gather the wrong (or padded) rows
        self.image_max_detections = image_max_detections
        self.eos_token = padding_idx if pad_eos else None
        self.classes = _load(classes_path, load_classes)

    @staticmethod
    def get_detections_inside(det_boxes, query):
        cond = ((det_boxes[:, 0] >= det_boxes[query, 0])
                & (det_boxes[:, 1] >= det_boxes[query, 1])
                & (det_boxes[:, 2] <= det_boxes[query, 2])
                & (det_boxes[:, 3] <= det_boxes[query, 3]))
        return np.nonzero(cond)[0]

    def _fill(self, cls_seq, det_features, det_boxes, selected_classes,
              most_probable_dets, max_len):
        det_sequences = np.zeros((self.fix_length, self.max_detections,
                                  det_features.shape[-1]))
        for j, cls in enumerate(cls_seq[:max_len]):
            if cls == "_":
                det_sequences[j, :det_features.shape[0]] = most_probable_dets
            else:
                seed = [i for i, c in enumerate(selected_classes) if c == cls]
                if self.all_boxes:
                    det_ids = np.unique(np.concatenate(
                        [self.get_detections_inside(det_boxes, d)
                         for d in seed]))
                else:
                    det_ids = np.unique(seed)
                det_sequences[j, :len(det_ids)] = np.take(
                    det_features, det_ids, axis=0)[:self.max_detections]
        if not self.sorting:
            last = len(cls_seq[:max_len])
            det_sequences[last:] = det_sequences[last - 1]
        return det_sequences.astype(np.float32)

    def _fill_ids(self, cls_seq, det_boxes, selected_classes,
                  most_probable_idxs, max_len, n_dets):
        """Compact variant of _fill: same group selection, but emits row
        indices into the image's detection tensor (-1 = padding)."""
        ids = np.full((self.fix_length, self.max_detections), -1, np.int32)
        for j, cls in enumerate(cls_seq[:max_len]):
            if cls == "_":
                take = most_probable_idxs[:self.max_detections]
            else:
                seed = [i for i, c in enumerate(selected_classes) if c == cls]
                if self.all_boxes:
                    take = np.unique(np.concatenate(
                        [self.get_detections_inside(det_boxes, d)
                         for d in seed]))
                else:
                    take = np.unique(seed)
                take = take[:self.max_detections]
            take = np.asarray(take, np.int32)
            take = take[take < n_dets]
            ids[j, :len(take)] = take
        if not self.sorting:
            last = len(cls_seq[:max_len])
            ids[last:] = ids[last - 1]
        return ids

    def preprocess(self, x):
        image = x[0][0]
        det_classes = x[1]
        max_len = self.fix_length + (self.eos_token, self.eos_token
                                     ).count(None) - 2
        rec = self.store.get(coco_image_id(image))
        det_cls_probs, det_features, det_boxes = rec

        most_probable_idxs = np.argsort(np.max(det_cls_probs, -1)
                                        )[::-1][:self.max_detections]
        most_probable_dets = det_features[most_probable_idxs]
        selected = selected_classes_of(self.classes, det_cls_probs)

        cls_seq = []
        for i, cls in enumerate(det_classes):
            if cls is not None:
                cls_seq.append(cls)
            else:
                cls_ok = next((c for c in det_classes[i + 1:]
                               if c is not None), "_")
                cls_seq.append(cls_ok)

        cls_seq_gt = np.asarray([int(a != b) for a, b in
                                 zip(cls_seq[:-1], cls_seq[1:])] + [0])
        cls_seq_gt = cls_seq_gt[:max_len]
        cls_seq_gt = np.concatenate([cls_seq_gt,
                                     [self.eos_token, self.eos_token]])
        cls_seq_gt = np.concatenate(
            [cls_seq_gt,
             [self.padding_idx] * max(0, self.fix_length - len(cls_seq_gt))])
        cls_seq_gt = cls_seq_gt.astype(np.float32)

        cls_seq_test = [k for k, _ in groupby(det_classes) if k is not None]
        if self.compact:
            n_dets = min(len(det_features), self.image_max_detections)
            if self.sorting:
                cls_seq_test.sort()
                return self._fill_ids(cls_seq_test, det_boxes, selected,
                                      most_probable_idxs, max_len, n_dets)
            ids = self._fill_ids(cls_seq, det_boxes, selected,
                                 most_probable_idxs, max_len, n_dets)
            ids_test = self._fill_ids(cls_seq_test, det_boxes, selected,
                                      most_probable_idxs, max_len, n_dets)
            return ids, cls_seq_gt, ids_test, " ".join(cls_seq_test)
        if self.sorting:
            cls_seq_test.sort()
            return self._fill(cls_seq_test, det_features, det_boxes, selected,
                              most_probable_dets, max_len)
        det_sequences = self._fill(cls_seq, det_features, det_boxes, selected,
                                   most_probable_dets, max_len)
        det_sequences_test = self._fill(cls_seq_test, det_features, det_boxes,
                                        selected, most_probable_dets, max_len)
        return (det_sequences, cls_seq_gt, det_sequences_test,
                " ".join(cls_seq_test))


# ---------------------------------------------------------------------------
# D6: ImageDetectionsField — ref :114-152
# ---------------------------------------------------------------------------

class ImageDetectionsField(RawField):
    def __init__(self, store, max_detections=100, sort_by_prob=False,
                 preprocessing=None, postprocessing=None):
        super().__init__(preprocessing, postprocessing)
        self.store = store
        self.max_detections = max_detections
        self.sort_by_prob = sort_by_prob

    def preprocess(self, x, avoid_precomp=False):
        image_id = coco_image_id(x)
        rec = self.store.get(image_id)
        precomp = rec.features
        if self.sort_by_prob:
            precomp = precomp[np.argsort(np.max(rec.cls_probs, -1))[::-1]]
        delta = self.max_detections - precomp.shape[0]
        if delta > 0:
            precomp = np.concatenate(
                [precomp, np.zeros((delta, precomp.shape[1]))], 0)
        elif delta < 0:
            precomp = precomp[:self.max_detections]
        return precomp.astype(np.float32), image_id

    def preprocess_batch(self, xs):
        """Whole-batch ingest: ONE multithreaded native gather from the
        packed store's memmap into the padded (B, max_det, D) batch
        (csrc/packed_reader.cpp), replacing B per-item reads — the
        DataLoader calls this via PairedDataset.get_batch. Values identical
        to preprocess() (tests/test_torch_data.py). Both paths give f32,
        a bf16-at-rest store's values widened (data/store.py), so the
        per-item path needs no cast back to the store's dtype."""
        from vsrcic_tpu_torch.data.native_reader import batch_features
        from vsrcic_tpu_torch.data.store import PackedFeatureStore
        ids = [coco_image_id(x) for x in xs]
        if (self.sort_by_prob
                or not isinstance(self.store, PackedFeatureStore)
                or any(str(i) not in self.store.index for i in ids)):
            return [self.preprocess(x) for x in xs]
        feats = batch_features(self.store, ids, self.max_detections)
        return [(feats[j], ids[j]) for j in range(len(ids))]


# ---------------------------------------------------------------------------
# D7: COCOControlSetField (Sinkhorn training, COCO) — ref :156-270
# ---------------------------------------------------------------------------

class COCOControlSetField(RawField):
    def __init__(self, store, classes_path=None, img_shapes_path=None,
                 precomp_glove_path=None, verb_idx_path=None,
                 idx_vs_path=None, cap_classes_path=None, cap_verb_path=None,
                 fix_length=20, max_detections=20, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.verb_2_idx = _load(verb_idx_path, _load_json)
        self.idx_2_vs = _load(idx_vs_path, _load_json)
        self.cap_2_classes = _load(cap_classes_path, _load_json)
        self.cap_2_verb = _load(cap_verb_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        id_image = coco_image_id(image)
        det_cls_probs, det_features, det_boxes = self.store.get(id_image)

        idx_2_verb = self.idx_2_vs[str(id_image)][caption]["verb"]
        idx_2_sr = self.idx_2_vs[str(id_image)][caption]["sr"]
        cap_2_verb = self.cap_2_verb[str(id_image)][caption]
        cls_seq = list(self.cap_2_classes[str(id_image)][caption])

        selected = selected_classes_of(self.classes, det_cls_probs)
        width, height = self.img_shapes[str(id_image)]
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        gt_sr = np.zeros((L, 8))
        gt_v = np.zeros((L, 8))
        idx_list = np.full((L, 1), -1.0)

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            control_verb[j] = self.verb_2_idx[verb] + 1

        cls_seq = cls_seq[:L]
        for j, cls in enumerate(cls_seq):
            for k, sr in enumerate(idx_2_sr[j]):
                if k == 8:
                    break
                gt_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                gt_v[j, k] = self.verb_2_idx[idx_2_verb[j][k]] + 1

        idx_list_ = np.array(cls_seq).argsort()
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        cls_seq.sort()  # alphabetical "shuffle" (ref :244)
        for j, cls in enumerate(cls_seq):
            cls_w = cls.split(",")[0].split(" ")[-1]
            if cls_w in self.vectors:
                word[j] = self.vectors[cls_w]
            seed = [i for i, c in enumerate(selected) if c == cls]
            det_ids = np.unique(seed)
            vis_all[j, :len(det_ids)] = np.take(
                det_features, det_ids, axis=0)[:M]
            vis[j] = det_features[det_ids[0]]
            pos[j] = box_position(det_boxes[det_ids[0]], width, height)
            for k, sr in enumerate(idx_2_sr[int(idx_list[j][0])]):
                if k >= 8:
                    continue
                seq_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                seq_v[j, k] = self.verb_2_idx[
                    idx_2_verb[int(idx_list[j][0])][k]] + 1

        f32 = np.float32
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), gt_v.astype(f32), gt_sr.astype(f32),
                idx_list)


# ---------------------------------------------------------------------------
# D9: COCOControlSetField_Verb (S-SSP train / eval, GT regions) — ref :384-541
# ---------------------------------------------------------------------------

class COCOControlSetField_Verb(RawField):
    def __init__(self, store, classes_path=None, img_shapes_path=None,
                 precomp_glove_path=None, verb_idx_path=None,
                 idx_vs_path=None, cap_classes_path=None, cap_verb_path=None,
                 vocab_path=None, idx_2_verb_og_path=None, verb_vob_path=None,
                 fix_length=20, max_detections=20, gt_verb=False,
                 postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.gt_verb = gt_verb
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.cap_2_classes = _load(cap_classes_path, _load_json)
        self.idx_2_vs = _load(idx_vs_path, _load_json)
        self.verb_2_idx = _load(verb_idx_path, _load_json)
        self.cap_2_verb = _load(cap_verb_path, _load_json)
        vocab_list = _load(vocab_path, _load_json)
        self.vocab_2_idx = {v: i for i, v in enumerate(vocab_list)}
        self.idx_2_v_og = _load(idx_2_verb_og_path, _load_json)
        self.verb_2_vob = _load(verb_vob_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        id_image = coco_image_id(image)
        det_cls_probs, det_features, det_boxes = self.store.get(id_image)

        idx_2_verb = self.idx_2_vs[str(id_image)][caption]["verb"]
        idx_2_sr = self.idx_2_vs[str(id_image)][caption]["sr"]
        idx_2_v_og = self.idx_2_v_og[str(id_image)][caption]
        cap_2_verb = self.cap_2_verb[str(id_image)][caption]
        cls_seq = list(self.cap_2_classes[str(id_image)][caption])

        selected = selected_classes_of(self.classes, det_cls_probs)
        width, height = self.img_shapes[str(id_image)]
        pooled_feat = np.mean(det_features, axis=0)
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        gt_sr = np.zeros((L, 8))
        gt_v = np.zeros((L, 8))
        verb_list = np.full((L, 1), -1.0)
        verb_list_og = np.full((L, 1), -1.0)
        idx_list = np.full((L, 1), -1.0)

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            control_verb[j] = self.verb_2_idx[verb] + 1

        cls_seq = cls_seq[:L]
        for j, cls in enumerate(cls_seq):
            for k, sr in enumerate(idx_2_sr[j]):
                if k >= 8:
                    continue
                gt_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                gt_v[j, k] = self.verb_2_idx[idx_2_verb[j][k]] + 1

        # random shuffle as permutation GT (ref :492-497)
        idx_rank = list(range(L))
        rank_use = list(zip(cls_seq, idx_rank))
        random.shuffle(rank_use)
        cls_seq, idx_list_ = zip(*rank_use)
        idx_list_ = np.array(idx_list_)
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        for j, cls in enumerate(cls_seq):
            if cls == "_":
                continue
            if cls != "verb":
                cls_w = cls.split(",")[0].split(" ")[-1]
                if cls_w in self.vectors:
                    word[j] = self.vectors[cls_w]
                seed = [i for i, c in enumerate(selected) if c == cls]
                det_ids = np.unique(seed)
                vis_all[j, :len(det_ids)] = np.take(
                    det_features, det_ids, axis=0)[:M]
                vis[j] = det_features[det_ids[0]]
                pos[j] = box_position(det_boxes[det_ids[0]], width, height)
            else:
                vis_all[j, 0] = pooled_feat
                if idx_2_verb[int(idx_list[j][0])] != []:
                    if idx_2_v_og[int(idx_list[j][0])][0] in self.vocab_2_idx:
                        verb_list_og[j, :] = self.vocab_2_idx[
                            idx_2_v_og[int(idx_list[j][0])][0]]
                    else:
                        verb_list_og[j, :] = 0
                    verb_list[j, :] = self.verb_2_idx[
                        idx_2_verb[int(idx_list[j][0])][0]] + 1

            for k, sr in enumerate(idx_2_sr[int(idx_list[j][0])]):
                if k >= 8:
                    continue
                seq_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                seq_v[j, k] = self.verb_2_idx[
                    idx_2_verb[int(idx_list[j][0])][k]] + 1

        f32 = np.float32
        vl = verb_list_og if self.gt_verb else verb_list
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), gt_v.astype(f32), gt_sr.astype(f32),
                idx_list, vl)


# ---------------------------------------------------------------------------
# D8: COCODetSetField (detected-region Sinkhorn variant) — ref :273-381
# ---------------------------------------------------------------------------

class COCODetSetField(RawField):
    def __init__(self, store, verb_idx_path=None, classes_path=None,
                 img_shapes_path=None, precomp_glove_path=None,
                 cls_seq_path=None, fix_length=20, max_detections=20,
                 postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.verb_2_idx = _load(verb_idx_path, _load_json)
        self.img_cap_v_2_class = _load(cls_seq_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        id_image = coco_image_id(image)
        det_cls_probs, det_features, det_boxes = self.store.get(id_image)

        v_2_class = self.img_cap_v_2_class[str(id_image)][caption]
        classes_seq = []
        loc_2_verb: Dict[int, list] = {}
        loc_2_sr: Dict[int, list] = {}
        loc = 0
        cap_2_verb: List[str] = []
        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for class_idx in v_2_class[verb][sr]:
                    if verb not in cap_2_verb:
                        cap_2_verb.append(verb)
                    classes_seq.append(class_idx)
                    loc_2_verb.setdefault(loc, []).append(verb)
                    loc_2_sr.setdefault(loc, []).append(sr)
                    loc += 1

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            control_verb[j] = self.verb_2_idx[verb] + 1

        cls_seq = [self.classes[ci] for ci in classes_seq]
        selected = selected_classes_of(self.classes, det_cls_probs)
        width, height = self.img_shapes[str(id_image)]
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        idx_list = np.full((L, 1), -1.0)

        cls_seq = cls_seq[:L]
        idx_list_ = np.array(cls_seq).argsort()
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        cls_seq.sort()
        for j, cls in enumerate(cls_seq):
            cls_w = cls.split(",")[0].split(" ")[-1]
            if cls_w in self.vectors:
                word[j] = self.vectors[cls_w]
            seed = [i for i, c in enumerate(selected) if c == cls]
            det_ids = np.unique(seed)
            vis_all[j, :len(det_ids)] = np.take(
                det_features, det_ids, axis=0)[:M]
            vis[j] = det_features[det_ids[0]]
            pos[j] = box_position(det_boxes[det_ids[0]], width, height)
            for k, sr in enumerate(loc_2_sr[int(idx_list[j][0])]):
                if k >= 8:
                    continue
                seq_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                seq_v[j, k] = self.verb_2_idx[
                    loc_2_verb[int(idx_list[j][0])][k]] + 1

        f32 = np.float32
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), idx_list)


# ---------------------------------------------------------------------------
# D10: COCODetSetField_Verb (eval --det, COCO) — ref :544-714
# ---------------------------------------------------------------------------

class COCODetSetField_Verb(RawField):
    def __init__(self, store, cls_seq_path=None, vocab_path=None,
                 vlem_2_v_og_path=None, verb_idx_path=None, classes_path=None,
                 img_shapes_path=None, precomp_glove_path=None, fix_length=20,
                 max_detections=20, gt_verb=False, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.gt_verb = gt_verb
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.verb_2_idx = _load(verb_idx_path, _load_json)
        vocab_list = _load(vocab_path, _load_json)
        self.vocab_2_idx = {v: i for i, v in enumerate(vocab_list)}
        self.vlem_2_verb = _load(vlem_2_v_og_path, _load_json)
        self.img_cap_v_2_class = _load(cls_seq_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x, rand=True):
        image, caption = x[0][0], x[0][1]
        id_image = coco_image_id(image)
        det_cls_probs, det_features, det_boxes = self.store.get(id_image)

        v_2_class = self.img_cap_v_2_class[str(id_image)][caption]
        classes_seq = []
        loc_2_verb: Dict[int, list] = {}
        loc_2_sr: Dict[int, list] = {}
        loc = 0
        cap_2_verb: List[str] = []
        vlem_2_verb = self.vlem_2_verb[str(id_image)][caption]
        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for class_idx in v_2_class[verb][sr]:
                    if verb not in cap_2_verb:
                        cap_2_verb.append(verb)
                    classes_seq.append(class_idx)

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            control_verb[j] = self.verb_2_idx[verb] + 1

        # 'verb' tokens prepended to the class sequence (ref :624-631)
        cls_seq: List[str] = []
        for verb in cap_2_verb:
            cls_seq.append("verb")
            loc_2_verb.setdefault(loc, []).append(verb)
            loc_2_sr.setdefault(loc, []).append("V")
            loc += 1
        cls_seq += [self.classes[ci] for ci in classes_seq]
        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for class_idx in v_2_class[verb][sr]:
                    loc_2_verb.setdefault(loc, []).append(verb)
                    loc_2_sr.setdefault(loc, []).append(sr)
                    loc += 1

        selected = selected_classes_of(self.classes, det_cls_probs)
        width, height = self.img_shapes[str(id_image)]
        pooled_feat = np.mean(det_features, axis=0)
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        idx_list = np.full((L, 1), -1.0)
        verb_list = np.full((L, 1), -1.0)

        cls_seq = cls_seq[:L]
        idx_rank = list(range(L))
        rank_use = list(zip(cls_seq, idx_rank))
        random.shuffle(rank_use)
        cls_seq, idx_list_ = zip(*rank_use)
        idx_list_ = np.array(idx_list_)
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        for j, cls in enumerate(cls_seq):
            if cls != "verb":
                cls_w = cls.split(",")[0].split(" ")[-1]
                if cls_w in self.vectors:
                    word[j] = self.vectors[cls_w]
                seed = [i for i, c in enumerate(selected) if c == cls]
                det_ids = np.unique(seed) if seed != [] else \
                    np.array([], np.int64)
                if len(det_ids) == 0:
                    det_ids = [1]
                vis_all[j, :len(det_ids)] = np.take(
                    det_features, det_ids, axis=0)[:M]
                vis[j] = det_features[det_ids[0]]
                pos[j] = box_position(det_boxes[det_ids[0]], width, height)
            else:
                vis_all[j, 0] = pooled_feat
                if loc_2_verb[int(idx_list[j][0])] != []:
                    if self.gt_verb is False:
                        verb_list[j, :] = self.verb_2_idx[
                            loc_2_verb[int(idx_list[j][0])][0]] + 1
                    else:
                        for v_lem, verb_og in vlem_2_verb:
                            if v_lem == loc_2_verb[int(idx_list[j][0])][0]:
                                if verb_og in self.vocab_2_idx:
                                    verb_list[j, :] = self.vocab_2_idx[verb_og]
                                else:
                                    verb_list[j, :] = 0
                                break

            for k, sr in enumerate(loc_2_sr[int(idx_list[j][0])]):
                if k >= 8:
                    continue
                seq_sr[j, k] = self.sr_2_idx[sr.split("-")[-1]]
                seq_v[j, k] = self.verb_2_idx[
                    loc_2_verb[int(idx_list[j][0])][k]] + 1

        f32 = np.float32
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), idx_list, verb_list)
