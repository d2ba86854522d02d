"""Flickr30k Entities field preprocessors (D11-D15 in SURVEY.md §2.2).

A copy of `vsrcic_tpu/data/fields_flickr.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

Behavioral ports of reference data/field.py:718-1389. Key preserved quirks:
IoU matching of GT entity boxes to detections (ref :784-796), the
`idx + 1 + 10000*occurrence` verb-id encoding (ref :844-845), the
single-best-IoU box selection of the *_Verb field (ref :1171-1196), and the
verb slots appended at the end for the detected-region field (ref :1329-1334).
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from vsrcic_tpu_torch.data.fields import (
    RawField, SR_2_IDX, _load, _load_json, _load_pickle, load_classes,
    selected_classes_of, flickr_image_id, box_position)


def bb_iou(boxA, boxB) -> float:
    """ref :784-796 (+1 convention preserved)."""
    xA = max(boxA[0], boxB[0])
    yA = max(boxA[1], boxB[1])
    xB = min(boxA[2], boxB[2])
    yB = min(boxA[3], boxB[3])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    areaA = (boxA[2] - boxA[0] + 1) * (boxA[3] - boxA[1] + 1)
    areaB = (boxB[2] - boxB[0] + 1) * (boxB[3] - boxB[1] + 1)
    return inter / (areaA + areaB - inter)


# ---------------------------------------------------------------------------
# D11: FlickrDetectionField — ref :718-742
# ---------------------------------------------------------------------------

class FlickrDetectionField(RawField):
    def __init__(self, store, diverse=False, max_detections=100,
                 preprocessing=None, postprocessing=None):
        super().__init__(preprocessing, postprocessing)
        self.store = store
        self.max_detections = max_detections
        self.diverse = diverse

    def preprocess(self, x, avoid_precomp=False):
        # the reference returns an *int* id here (ref :727), unlike the
        # string ids used by the other Flickr fields — keys in the eval
        # pipeline's per-image dicts depend on it
        image_id = int(flickr_image_id(x))
        precomp = self.store.get(image_id).features
        delta = self.max_detections - precomp.shape[0]
        if delta > 0:
            precomp = np.concatenate(
                [precomp, np.zeros((delta, precomp.shape[1]))], 0)
        elif delta < 0:
            precomp = precomp[:self.max_detections]
        if self.diverse:
            return precomp.astype(np.float32), image_id
        return precomp.astype(np.float32)

    def preprocess_batch(self, xs):
        """Batched native ingest — see ImageDetectionsField.preprocess_batch."""
        from vsrcic_tpu_torch.data.native_reader import batch_features
        from vsrcic_tpu_torch.data.store import PackedFeatureStore
        ids = [int(flickr_image_id(x)) for x in xs]
        if (not isinstance(self.store, PackedFeatureStore)
                or any(str(i) not in self.store.index for i in ids)):
            return [self.preprocess(x) for x in xs]
        feats = batch_features(self.store, ids, self.max_detections)
        if self.diverse:
            return [(feats[j], ids[j]) for j in range(len(ids))]
        return [feats[j] for j in range(len(ids))]


# ---------------------------------------------------------------------------
# D12: FlickrControlSetField — ref :746-908 (superseded in-repo by _Verb)
# ---------------------------------------------------------------------------

class FlickrControlSetField(RawField):
    def __init__(self, store, idx_vs_path=None, cap_verb_path=None,
                 cap_classes_path=None, verb_idx_path=None, classes_path=None,
                 img_shapes_path=None, precomp_glove_path=None, fix_length=20,
                 max_detections=20, visual=True, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.visual = visual
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.flickr_verb_idx = _load(verb_idx_path, _load_json)
        self.idx_2_vs = _load(idx_vs_path, _load_json)
        self.cap_2_verb = _load(cap_verb_path, _load_json)
        self.cap_2_classes = _load(cap_classes_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def _verb_code(self, verb: str) -> float:
        return (self.flickr_verb_idx[verb.split("_")[0]] + 1
                + 10000 * int(verb.split("_")[-1]))

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        gt_bboxes = x[1]
        id_image = flickr_image_id(image)
        if self.visual:
            det_cls_probs, det_features, det_bboxes = self.store.get(id_image)

        idx_2_verb = self.idx_2_vs[id_image][caption]["verb"]
        idx_2_sr = self.idx_2_vs[id_image][caption]["sr"]
        cap_2_verb = self.cap_2_verb[id_image][caption]
        cls_seq = [c - 1 for c in self.cap_2_classes[id_image][caption]]

        L, M = self.fix_length, self.max_detections
        if self.visual:
            selected = selected_classes_of(self.classes, det_cls_probs)
            width, height = self.img_shapes[str(id_image)]
            vis_all = np.zeros((L, M, det_features.shape[-1]))
            vis = np.zeros((L, det_features.shape[-1]))
            word = np.zeros((L, 300))
            pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        gt_sr = np.zeros((L, 8))
        gt_v = np.zeros((L, 8))

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            if j >= 8:
                continue
            control_verb[j] = self._verb_code(verb)

        idx_list = np.full((L, 1), -1.0)
        cls_seq = cls_seq[:L]
        for j, _ in enumerate(cls_seq):
            for k, sr in enumerate(idx_2_sr[j]):
                if idx_2_verb[j][k] in cap_2_verb:
                    gt_sr[j, k] = sr
                    gt_v[j, k] = self._verb_code(idx_2_verb[j][k])

        idx_rank = list(range(L))
        rank_use = list(zip(cls_seq, idx_rank))
        random.shuffle(rank_use)
        cls_seq, idx_list_ = zip(*rank_use)
        idx_list_ = np.array(idx_list_)
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        for j, cls in enumerate(cls_seq):
            if self.visual:
                id_boxes = []
                for bbox in gt_bboxes[cls]:
                    id_bbox, iou_max = -1, 0
                    for ii, det_bbox in enumerate(det_bboxes):
                        iou = bb_iou(bbox, det_bbox)
                        if iou_max < iou:
                            id_bbox, iou_max = ii, iou
                    id_boxes.append(id_bbox)
                id_boxes.sort()
                cls_w = selected[id_boxes[0]].split(",")[0].split(" ")[-1]
                if cls_w in self.vectors:
                    word[j] = self.vectors[cls_w]
                vis_all[j, :len(id_boxes)] = np.take(
                    det_features, id_boxes, axis=0)[:M]
                vis[j] = det_features[id_boxes[0]]
                pos[j] = box_position(det_bboxes[id_boxes[0]], width, height)

            for k, sr in enumerate(idx_2_sr[int(idx_list[j][0])]):
                if idx_2_verb[int(idx_list[j][0])][k] in cap_2_verb:
                    seq_sr[j, k] = sr
                    seq_v[j, k] = self._verb_code(
                        idx_2_verb[int(idx_list[j][0])][k])

        f32 = np.float32
        if self.visual:
            return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                    vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                    control_verb.astype(f32), gt_v.astype(f32),
                    gt_sr.astype(f32), idx_list)
        return (seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), gt_v.astype(f32), gt_sr.astype(f32),
                idx_list)


# ---------------------------------------------------------------------------
# D14: FlickrControlSetField_Verb — ref :1032-1231
# ---------------------------------------------------------------------------

class FlickrControlSetField_Verb(RawField):
    def __init__(self, store, idx_vs_path=None, cap_verb_path=None,
                 cap_classes_path=None, verb_idx_path=None, idx_v_og_path=None,
                 vocab_list_path=None, classes_path=None, img_shapes_path=None,
                 precomp_glove_path=None, fix_length=20, max_detections=20,
                 visual=True, gt_verb=False, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.visual = visual
        self.gt_verb = gt_verb
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.idx_2_vs = _load(idx_vs_path, _load_json)
        self.cap_2_verb = _load(cap_verb_path, _load_json)
        self.cap_2_classes = _load(cap_classes_path, _load_json)
        self.flickr_verb_idx = _load(verb_idx_path, _load_json)
        self.idx_2_v_og = _load(idx_v_og_path, _load_json)
        vocab_list = _load(vocab_list_path, _load_json)
        self.vocab_2_idx = {v: i for i, v in enumerate(vocab_list)}
        self.sr_2_idx = SR_2_IDX

    def _verb_code(self, verb: str) -> float:
        return (self.flickr_verb_idx[verb.split("_")[0]] + 1
                + 10000 * int(verb.split("_")[-1]))

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        gt_bboxes = x[1]
        id_image = flickr_image_id(image)
        if self.visual:
            det_cls_probs, det_features, det_bboxes = self.store.get(id_image)

        idx_2_verb = self.idx_2_vs[id_image][caption]["verb"]
        idx_2_v_og = self.idx_2_v_og[id_image][caption]
        idx_2_sr = self.idx_2_vs[id_image][caption]["sr"]
        cap_2_verb = self.cap_2_verb[id_image][caption]
        cls_seq = [c - 1 for c in self.cap_2_classes[id_image][caption]]

        L, M = self.fix_length, self.max_detections
        if self.visual:
            selected = selected_classes_of(self.classes, det_cls_probs)
            width, height = self.img_shapes[str(id_image)]
            pooled_feat = np.mean(det_features, axis=0)
            vis_all = np.zeros((L, M, det_features.shape[-1]))
            vis = np.zeros((L, det_features.shape[-1]))
            word = np.zeros((L, 300))
            pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        gt_sr = np.zeros((L, 8))
        gt_v = np.zeros((L, 8))

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            if j >= 8:
                continue
            control_verb[j] = self._verb_code(verb)

        verb_list = np.full((L, 1), -1.0)
        verb_list_og = np.full((L, 1), -1.0)
        idx_list = np.full((L, 1), -1.0)

        cls_seq = cls_seq[:L]
        for j, _ in enumerate(cls_seq):
            for k, sr in enumerate(idx_2_sr[j]):
                if idx_2_verb[j][k] in cap_2_verb:
                    gt_sr[j, k] = sr
                    gt_v[j, k] = self._verb_code(idx_2_verb[j][k])

        idx_rank = list(range(L))
        rank_use = list(zip(cls_seq, idx_rank))
        random.shuffle(rank_use)
        cls_seq, idx_list_ = zip(*rank_use)
        idx_list_ = np.array(idx_list_)
        idx_list[:len(idx_list_), :] = idx_list_[:, np.newaxis]

        for j, cls in enumerate(cls_seq):
            if self.visual:
                if cls >= 0:
                    iou_max_max, only_box = 0, -1
                    id_boxes = []
                    for bbox in gt_bboxes[cls]:
                        id_bbox, iou_max = -1, 0
                        for ii, det_bbox in enumerate(det_bboxes):
                            iou = bb_iou(bbox, det_bbox)
                            if iou_max < iou:
                                id_bbox, iou_max = ii, iou
                        if iou_max_max < iou_max:
                            only_box, iou_max_max = id_bbox, iou_max
                        id_boxes.append(id_bbox)
                    id_boxes.sort()
                    vis_all[j, 0] = det_features[only_box]
                    vis[j] = det_features[only_box]
                    pos[j] = box_position(det_bboxes[only_box], width, height)
                else:
                    vis_all[j, 0] = pooled_feat
                    il = int(idx_list[j][0])
                    if (idx_2_verb[il] != [] and idx_2_verb[il][0].split("_")[0]
                            in self.flickr_verb_idx):
                        verb_list[j, :] = self.flickr_verb_idx[
                            idx_2_verb[il][0].split("_")[0]] + 1
                        if idx_2_v_og[il][0] in self.vocab_2_idx:
                            verb_list_og[j, :] = self.vocab_2_idx[
                                idx_2_v_og[il][0]]
                        else:
                            verb_list_og[j, :] = 0

            for k, sr in enumerate(idx_2_sr[int(idx_list[j][0])]):
                if idx_2_verb[int(idx_list[j][0])][k] in cap_2_verb:
                    seq_sr[j, k] = sr
                    seq_v[j, k] = self._verb_code(
                        idx_2_verb[int(idx_list[j][0])][k])

        f32 = np.float32
        vl = verb_list_og if self.gt_verb else verb_list
        if self.visual:
            return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                    vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                    control_verb.astype(f32), gt_v.astype(f32),
                    gt_sr.astype(f32), idx_list, vl)
        return (seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), gt_v.astype(f32), gt_sr.astype(f32),
                idx_list, vl)


# ---------------------------------------------------------------------------
# D13: FlickrDetSetField — ref :911-1029 (superseded in-repo by _Verb)
# ---------------------------------------------------------------------------

class FlickrDetSetField(RawField):
    def __init__(self, store, verb_idx_path=None, verb_vob_path=None,
                 idbox_seq_path=None, classes_path=None, img_shapes_path=None,
                 precomp_glove_path=None, fix_length=20, max_detections=20,
                 visual=True, postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.visual = visual
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.flickr_verb_idx = _load(verb_idx_path, _load_json)
        self.verb_2_vob = _load(verb_vob_path, _load_json)
        self.img_cap_v_2_idbox = _load(idbox_seq_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        id_image = flickr_image_id(image)
        det_cls_probs, det_features, det_bboxes = self.store.get(id_image)
        v_2_class = self.img_cap_v_2_idbox[id_image][caption]

        loc_2_verb: Dict[int, list] = {}
        loc_2_sr: Dict[int, list] = {}
        loc = 0
        idbox_seq: Dict[int, int] = {}
        cap_2_verb: List[str] = []
        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for id_box in v_2_class[verb][sr]:
                    if verb not in cap_2_verb:
                        cap_2_verb.append(verb)
                    if id_box not in idbox_seq:
                        idbox_seq[id_box] = loc
                        loc += 1

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            if j >= 8:
                continue
            control_verb[j] = self.flickr_verb_idx[verb.split("_")[0]] + 1

        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for id_box in v_2_class[verb][sr]:
                    loc_ = idbox_seq[id_box]
                    loc_2_verb.setdefault(loc_, []).append(verb)
                    loc_2_sr.setdefault(loc_, []).append(sr)

        width, height = self.img_shapes[str(id_image)]
        selected = selected_classes_of(self.classes, det_cls_probs)
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))

        for j, idbox in enumerate(idbox_seq):
            if j == 10:
                break
            vis_all[j, 0] = det_features[idbox]
            vis[j] = det_features[idbox]
            cls_w = selected[idbox].split(",")[0].split(" ")[-1]
            if cls_w in self.vectors:
                word[j] = self.vectors[cls_w]
            pos[j] = box_position(det_bboxes[idbox], width, height)
            for k, sr in enumerate(loc_2_sr[j]):
                if k >= 8:
                    continue
                seq_sr[j, k] = sr
                seq_v[j, k] = self.flickr_verb_idx[
                    loc_2_verb[j][k].split("_")[0]] + 1

        f32 = np.float32
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32))


# ---------------------------------------------------------------------------
# D15: FlickrDetSetField_Verb — ref :1234-1389
# ---------------------------------------------------------------------------

class FlickrDetSetField_Verb(RawField):
    def __init__(self, store, verb_idx_path=None, verb_vob_path=None,
                 idbox_seq_path=None, vocab_list_path=None,
                 vlem_2_verb_og_path=None, classes_path=None,
                 img_shapes_path=None, precomp_glove_path=None, fix_length=20,
                 max_detections=20, visual=True, gt_verb=False,
                 postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.fix_length = fix_length
        self.max_detections = max_detections
        self.visual = visual
        self.gt_verb = gt_verb
        self.classes = _load(classes_path, load_classes)
        self.vectors = _load(precomp_glove_path, _load_pickle)
        self.img_shapes = _load(img_shapes_path, _load_json)
        self.flickr_verb_idx = _load(verb_idx_path, _load_json)
        self.verb_2_vob = _load(verb_vob_path, _load_json)
        self.img_cap_v_2_idbox = _load(idbox_seq_path, _load_json)
        vocab_list = _load(vocab_list_path, _load_json)
        self.vocab_2_idx = {v: i for i, v in enumerate(vocab_list)}
        self.vlem_2_verb = _load(vlem_2_verb_og_path, _load_json)
        self.sr_2_idx = SR_2_IDX

    def preprocess(self, x):
        image, caption = x[0][0], x[0][1]
        id_image = flickr_image_id(image)
        det_cls_probs, det_features, det_bboxes = self.store.get(id_image)
        v_2_class = self.img_cap_v_2_idbox[id_image][caption]
        vlem_2_verb = self.vlem_2_verb[id_image][caption]

        loc_2_verb: Dict[int, list] = {}
        loc_2_sr: Dict[int, list] = {}
        loc = 0
        idbox_seq: Dict[int, int] = {}
        cap_2_verb: List[str] = []
        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for id_box in v_2_class[verb][sr]:
                    if verb not in cap_2_verb:
                        cap_2_verb.append(verb)
                    if id_box not in idbox_seq:
                        idbox_seq[id_box] = loc
                        loc += 1

        control_verb = np.zeros(8)
        for j, verb in enumerate(cap_2_verb):
            if j >= 8:
                continue
            control_verb[j] = self.flickr_verb_idx[verb.split("_")[0]] + 1

        for verb in v_2_class:
            for sr in v_2_class[verb]:
                for id_box in v_2_class[verb][sr]:
                    loc_ = idbox_seq[id_box]
                    loc_2_verb.setdefault(loc_, []).append(verb)
                    loc_2_sr.setdefault(loc_, []).append(sr)

        # verb slots appended at the end (ref :1329-1334)
        for verb in cap_2_verb:
            idbox_seq[-1] = loc
            loc_2_verb.setdefault(loc, []).append(verb)
            loc_2_sr.setdefault(loc, []).append(25)
            loc += 1

        width, height = self.img_shapes[str(id_image)]
        pooled_feat = np.mean(det_features, axis=0)
        selected = selected_classes_of(self.classes, det_cls_probs)
        L, M = self.fix_length, self.max_detections
        vis_all = np.zeros((L, M, det_features.shape[-1]))
        vis = np.zeros((L, det_features.shape[-1]))
        word = np.zeros((L, 300))
        pos = np.zeros((L, 4))
        seq_sr = np.zeros((L, 8))
        seq_v = np.zeros((L, 8))
        verb_list = np.full((L, 1), -1.0)

        for j, idbox in enumerate(idbox_seq):
            if j == 10:
                break
            if idbox >= 0:
                vis_all[j, 0] = det_features[idbox]
                vis[j] = det_features[idbox]
                cls_w = selected[idbox].split(",")[0].split(" ")[-1]
                if cls_w in self.vectors:
                    word[j] = self.vectors[cls_w]
                pos[j] = box_position(det_bboxes[idbox], width, height)
            else:
                vis_all[j, 0] = pooled_feat
                if loc_2_verb[j] != []:
                    if self.gt_verb is False:
                        verb_list[j, :] = self.flickr_verb_idx[
                            loc_2_verb[j][0].split("_")[0]] + 1
                    else:
                        for v_lem, verb_og in vlem_2_verb:
                            if v_lem == loc_2_verb[j][0].split("_")[0]:
                                if verb_og in self.vocab_2_idx:
                                    verb_list[j, :] = self.vocab_2_idx[verb_og]
                                break

            for k, sr in enumerate(loc_2_sr[j]):
                if k >= 8:
                    continue
                seq_sr[j, k] = sr
                seq_v[j, k] = self.flickr_verb_idx[
                    loc_2_verb[j][k].split("_")[0]] + 1

        f32 = np.float32
        return (word.astype(f32), vis.astype(f32), pos.astype(f32),
                vis_all.astype(f32), seq_v.astype(f32), seq_sr.astype(f32),
                control_verb.astype(f32), verb_list)


# ---------------------------------------------------------------------------
# FlickrControlSequenceField — EXTENSION (no upstream counterpart)
# ---------------------------------------------------------------------------

class FlickrControlSequenceField(RawField):
    """Captioner-training control field for Flickr30k Entities (extension).

    The reference ships its Flickr captioner checkpoint pretrained and has no
    Flickr captioner-training script or field (SURVEY.md S7; reference
    flickr_scripts/ contains only planner/eval scripts). This field fills the
    gap by transplanting the COCO training-control semantics
    (COCOControlSequenceField, reference data/field.py:15-110) onto Flickr's
    entity annotations:

      * the per-word control comes from the caption's entity ids
        (FlickrEntities bracket parse), each entity's GT boxes matched to
        detection rows by best IoU exactly as the in-repo Flickr fields do
        (reference field.py:1171-1196) — unmatched boxes (IoU 0 everywhere)
        are dropped rather than wrap-indexed (the _Verb field's np.take(-1)
        quirk is not reproduced: there is no checkpoint pinning it here);
      * words with no entity carry the next entity forward, with the
        most-probable-detections fallback '_' (ref field.py:80-91 analog);
      * the shift-gate GT is 1 where consecutive word entities differ
        (ref field.py:93-97 analog);
      * test-time groups deduplicate consecutive entities (ref :99-110).

    `compact=True` emits (fix_length, max_detections) int32 detection-row
    indices (-1 padded) for on-device group expansion, as the COCO field.
    Returns (det_sequences, gate_gt, det_sequences_test, dedup_entity_str).
    """

    def __init__(self, store, padding_idx=0, fix_length=None, pad_eos=True,
                 max_detections=20, compact=False, image_max_detections=100,
                 postprocessing=None):
        super().__init__(None, postprocessing)
        self.store = store
        self.max_detections = max_detections
        self.padding_idx = padding_idx
        self.fix_length = fix_length
        self.compact = compact
        self.image_max_detections = image_max_detections
        self.eos_token = padding_idx if pad_eos else None

    def _entity_rows(self, ent, bdnboxes, det_boxes, most_probable_idxs):
        if ent == "_":
            return np.asarray(most_probable_idxs[:self.max_detections],
                              np.int64)
        take = []
        for bbox in bdnboxes[ent - 1]:
            best, iou_max = -1, 0.0
            for ii, det_bbox in enumerate(det_boxes):
                iou = bb_iou(bbox, det_bbox)
                if iou_max < iou:
                    best, iou_max = ii, iou
            if best >= 0:
                take.append(best)
        return np.unique(take)[:self.max_detections].astype(np.int64)

    def preprocess(self, x):
        from itertools import groupby

        image = x[0][0]
        bdnboxes = x[1]
        det_ids = list(x[2])
        max_len = self.fix_length + (self.eos_token, self.eos_token
                                     ).count(None) - 2
        det_cls_probs, det_features, det_boxes = self.store.get(
            flickr_image_id(image))
        most_probable_idxs = np.argsort(np.max(det_cls_probs, -1)
                                        )[::-1][:self.max_detections]

        ent_seq = []
        for i, ent in enumerate(det_ids):
            if ent != 0:
                ent_seq.append(ent)
            else:
                ent_seq.append(next((d for d in det_ids[i + 1:] if d != 0),
                                    "_"))

        gate_gt = np.asarray([int(a != b) for a, b in
                              zip(ent_seq[:-1], ent_seq[1:])] + [0])
        gate_gt = gate_gt[:max_len]
        gate_gt = np.concatenate([gate_gt, [self.eos_token, self.eos_token]])
        gate_gt = np.concatenate(
            [gate_gt,
             [self.padding_idx] * max(0, self.fix_length - len(gate_gt))])
        gate_gt = gate_gt.astype(np.float32)

        ent_seq_test = [k for k, _ in groupby(det_ids) if k != 0]
        n_dets = min(len(det_features), self.image_max_detections)

        def fill_ids(seq):
            ids = np.full((self.fix_length, self.max_detections), -1,
                          np.int32)
            for j, ent in enumerate(seq[:max_len]):
                take = self._entity_rows(ent, bdnboxes, det_boxes,
                                         most_probable_idxs)
                take = take[take < n_dets]
                ids[j, :len(take)] = take
            last = len(seq[:max_len])
            ids[last:] = ids[last - 1]
            return ids

        def fill(seq):
            out = np.zeros((self.fix_length, self.max_detections,
                            det_features.shape[-1]))
            for j, ent in enumerate(seq[:max_len]):
                take = self._entity_rows(ent, bdnboxes, det_boxes,
                                         most_probable_idxs)
                out[j, :len(take)] = np.take(det_features, take, axis=0)
            last = len(seq[:max_len])
            out[last:] = out[last - 1]
            return out.astype(np.float32)

        dedup = " ".join(str(e) for e in ent_seq_test)
        if self.compact:
            return (fill_ids(ent_seq), gate_gt, fill_ids(ent_seq_test), dedup)
        return (fill(ent_seq), gate_gt, fill(ent_seq_test), dedup)
