"""Datasets: COCO Entities & Flickr30k Entities + the dataset machinery the
reference gets from the external `speaksee` package (Example, PairedDataset,
DictionaryDataset, DataLoader — SURVEY.md L0, to be absorbed).

A copy of `vsrcic_tpu/data/dataset.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

The entities alignment logic is a behavioral port of reference
data/dataset.py:16-302 (noun-chunk -> detection-class control sequences,
verb/det filters, pickle split caches). Batches are numpy (host) — device
placement happens in the trainers.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import xml.etree.ElementTree
from itertools import groupby
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vsrcic_tpu_torch.text.vocab import PUNCTUATIONS


class Example:
    """Attribute bag (speaksee Example parity)."""

    @classmethod
    def fromdict(cls, d: Dict[str, Any]) -> "Example":
        ex = cls()
        for k, v in d.items():
            setattr(ex, k, v)
        return ex

    def __eq__(self, other):
        return isinstance(other, Example) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash(tuple(sorted((k, str(v)) for k, v in self.__dict__.items())))


class PairedDataset:
    """Examples + named fields; __getitem__ applies field.preprocess."""

    def __init__(self, examples: Sequence[Example], fields: Dict[str, Any]):
        self.examples = list(examples)
        self.fields = dict(fields)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i: int):
        ex = self.examples[i]
        return tuple(field.preprocess(getattr(ex, name))
                     for name, field in self.fields.items())

    def get_batch(self, idxs: Sequence[int], pool=None) -> List[tuple]:
        """Batch of items with per-field batching: a field exposing
        `preprocess_batch` ingests the whole batch at once (e.g. the native
        packed-store gather in ImageDetectionsField); the rest run
        per-example, on `pool` when given. Item tuples == [self[i] ...]."""
        cols = {}
        for name, field in self.fields.items():
            xs = [getattr(self.examples[i], name) for i in idxs]
            if hasattr(field, "preprocess_batch"):
                cols[name] = field.preprocess_batch(xs)
            elif pool is not None:
                cols[name] = list(pool.map(field.preprocess, xs))
            else:
                cols[name] = [field.preprocess(x) for x in xs]
        return [tuple(cols[name][j] for name in self.fields)
                for j in range(len(idxs))]

    def __getattr__(self, attr):
        if attr in self.__dict__.get("fields", {}):
            return [getattr(ex, attr) for ex in self.examples]
        raise AttributeError(attr)


class DictionaryDataset:
    """Groups examples by a key field; one item = (key value, all grouped
    field values) — speaksee DictionaryDataset parity (used to batch all
    captions of an image together, reference eval_coco.py:91)."""

    def __init__(self, examples: Sequence[Example], fields: Dict[str, Any],
                 key_field: str):
        self.key_field = key_field
        self.fields = dict(fields)
        key_index: Dict[Any, int] = {}
        self.groups: List[List[Example]] = []
        self.keys: List[Any] = []
        for ex in examples:
            k = getattr(ex, key_field)
            if k not in key_index:
                key_index[k] = len(self.groups)
                self.groups.append([])
                self.keys.append(k)
            self.groups[key_index[k]].append(ex)

    def __len__(self):
        return len(self.groups)

    def __getitem__(self, i: int):
        group = self.groups[i]
        key_val = self.fields[self.key_field].preprocess(self.keys[i])
        values = {}
        for name, field in self.fields.items():
            if name == self.key_field:
                continue
            values[name] = [field.preprocess(getattr(ex, name))
                            for ex in group]
        return key_val, values

    def get_batch(self, idxs: Sequence[int], pool=None) -> List[tuple]:
        """Batched items: the key field (detection features in the eval
        pipelines) goes through its `preprocess_batch` when available —
        one native gather for the batch's images."""
        key_field = self.fields[self.key_field]
        key_xs = [self.keys[i] for i in idxs]
        if hasattr(key_field, "preprocess_batch"):
            key_vals = key_field.preprocess_batch(key_xs)
        else:
            key_vals = [key_field.preprocess(x) for x in key_xs]
        def group_values(i):
            values = {}
            for name, field in self.fields.items():
                if name == self.key_field:
                    continue
                values[name] = [field.preprocess(getattr(ex, name))
                                for ex in self.groups[i]]
            return values
        if pool is not None:
            all_values = list(pool.map(group_values, idxs))
        else:
            all_values = [group_values(i) for i in idxs]
        return list(zip(key_vals, all_values))


def default_collate(items: List[Any]):
    """Stack homogeneous numpy outputs; tuples are collated per position."""
    first = items[0]
    if isinstance(first, tuple):
        return tuple(default_collate(list(col)) for col in zip(*items))
    if isinstance(first, np.ndarray):
        return np.stack(items, 0)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(items)
    return list(items)


def dict_collate(items: List[Tuple[Any, Dict[str, List[Any]]]]):
    """Collate DictionaryDataset items: keys stacked, values kept as nested
    per-image lists (variable captions per image)."""
    keys = default_collate([k for k, _ in items])
    names = items[0][1].keys()
    values = {}
    for name in names:
        per_image = [v[name] for _, v in items]
        # transpose inner tuples: list (per image) of list (per caption) of
        # field outputs; regroup to field-output-position-major like the
        # reference unpacks (det_seqs_txt, det_seqs_vis, ... = values)
        values[name] = per_image
    return keys, values


class DataLoader:
    """Batching loader (shuffle, drop_last=False).

    `num_workers > 0` preprocesses the batch's examples on a thread pool —
    the fields are pure numpy/h5py functions that release the GIL on I/O, so
    threads parallelize the reference's worker-process role without pickling.
    Combine with `vsrcic_tpu_torch.data.loader.PrefetchLoader` to overlap whole
    batches with device compute.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, collate_fn: Optional[Callable] = None,
                 seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.rng = np.random.RandomState(seed)
        if collate_fn is None:
            collate_fn = (dict_collate if isinstance(dataset, DictionaryDataset)
                          else default_collate)
        self.collate_fn = collate_fn
        self._pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = [int(i) for i in order[start:start + self.batch_size]]
            if hasattr(self.dataset, "get_batch"):
                # batched ingest path: fields with preprocess_batch (native
                # packed-store gather) read the whole batch at once
                items = self.dataset.get_batch(idxs, pool=self._pool)
            elif self._pool is not None:
                items = list(self._pool.map(self.dataset.__getitem__, idxs))
            else:
                items = [self.dataset[i] for i in idxs]
            yield self.collate_fn(items)


# ---------------------------------------------------------------------------
# COCO sample enumeration (speaksee COCO.get_samples parity)
# ---------------------------------------------------------------------------

def coco_get_samples(roots: Dict[str, Dict[str, Any]],
                     ids: Optional[Dict[str, Any]]):
    """Enumerate (image path, caption) examples for train/val/test.

    roots[split] = {'img': dir or (dir, dir), 'cap': json or (json, json)};
    ids[split] = annotation-id array or tuple for trainrestval.
    """
    def load_anns(cap_json):
        with open(cap_json) as f:
            data = json.load(f)
        anns = {a["id"]: a for a in data["annotations"]}
        imgs = {i["id"]: i for i in data["images"]}
        return anns, imgs

    out = {}
    for split in ("train", "val", "test"):
        root = roots[split]
        if isinstance(root["cap"], tuple):
            anns_list = [load_anns(c) for c in root["cap"]]
            img_roots = list(root["img"])
        else:
            anns_list = [load_anns(root["cap"])]
            img_roots = [root["img"]]
        if ids is not None:
            split_ids = ids[split]
            id_groups = (list(split_ids) if isinstance(split_ids, tuple)
                         else [split_ids])
        else:
            id_groups = [list(a[0].keys()) for a in anns_list]
        examples = []
        for gi, group in enumerate(id_groups):
            anns, imgs = anns_list[min(gi, len(anns_list) - 1)]
            img_root = img_roots[min(gi, len(img_roots) - 1)]
            for ann_id in group:
                ann = anns[int(ann_id)]
                file_name = imgs[ann["image_id"]]["file_name"]
                examples.append(Example.fromdict({
                    "image": os.path.join(img_root, file_name),
                    "text": ann["caption"]}))
        out[split] = examples
    return out["train"], out["val"], out["test"]


# ---------------------------------------------------------------------------
# COCOEntities (ref data/dataset.py:16-166)
# ---------------------------------------------------------------------------

class COCOEntities(PairedDataset):
    def __init__(self, image_field, det_field, text_field, img_root,
                 ann_root, entities_file, id_root=None,
                 data_root="saved_data/coco", use_restval=True,
                 filtering=False, det_filtering=False,
                 verb_filter_file=None, det_filter_file=None,
                 precomputed_samples=None):
        """`precomputed_samples` short-circuits annotation parsing with
        (train, val, test) example lists — used by the synthetic backend."""
        if precomputed_samples is not None:
            self.train_examples, self.val_examples, self.test_examples = \
                precomputed_samples
        else:
            roots = {
                "train": {"img": os.path.join(img_root, "train2014"),
                          "cap": os.path.join(ann_root, "captions_train2014.json")},
                "val": {"img": os.path.join(img_root, "val2014"),
                        "cap": os.path.join(ann_root, "captions_val2014.json")},
                "test": {"img": os.path.join(img_root, "val2014"),
                         "cap": os.path.join(ann_root, "captions_val2014.json")},
            }
            roots["trainrestval"] = {
                "img": (roots["train"]["img"], roots["val"]["img"]),
                "cap": (roots["train"]["cap"], roots["val"]["cap"])}
            if id_root is not None:
                ids = {
                    "train": np.load(os.path.join(id_root, "coco_train_ids.npy")),
                    "val": np.load(os.path.join(id_root, "coco_dev_ids.npy")),
                    "test": np.load(os.path.join(id_root, "coco_test_ids.npy")),
                }
                ids["trainrestval"] = (
                    ids["train"],
                    np.load(os.path.join(id_root, "coco_restval_ids.npy")))
                if use_restval:
                    roots["train"] = roots["trainrestval"]
                    ids["train"] = ids["trainrestval"]
            else:
                ids = None

            if det_filtering:
                cache = os.path.join(data_root, "coco_entities_det_precomp.pkl")
            elif filtering:
                cache = os.path.join(data_root,
                                     "coco_entities_filtered_precomp.pkl")
            else:
                cache = os.path.join(data_root, "coco_entities_precomp.pkl")

            if os.path.isfile(cache):
                with open(cache, "rb") as f:
                    (self.train_examples, self.val_examples,
                     self.test_examples) = pickle.load(f)
            else:
                samples = coco_get_samples(roots, ids)
                (self.train_examples, self.val_examples,
                 self.test_examples) = self.get_samples(
                    samples, entities_file, filtering, det_filtering,
                    verb_filter_file or os.path.join(
                        data_root, "img_caps_vb.json"),
                    det_filter_file or os.path.join(
                        data_root, "img_cap_v_2_class_self.json"))
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                with open(cache, "wb") as f:
                    pickle.dump((self.train_examples, self.val_examples,
                                 self.test_examples), f, -1)

        examples = (self.train_examples + self.val_examples
                    + self.test_examples)
        super().__init__(examples, {"image": image_field,
                                    "detection": det_field,
                                    "text": text_field})

    @property
    def splits(self):
        return (PairedDataset(self.train_examples, self.fields),
                PairedDataset(self.val_examples, self.fields),
                PairedDataset(self.test_examples, self.fields))

    @classmethod
    def get_samples(cls, samples, entities_file, filtering=False,
                    det_filtering=False, verb_filter_file=None,
                    det_filter_file=None):
        """Noun-chunk -> det-class control sequences + filters (ref :80-166)."""
        train_examples, val_examples, test_examples = [], [], []

        visual_chunks = entities_file
        if isinstance(entities_file, str):
            with open(entities_file) as fp:
                visual_chunks = json.load(fp)
        img_caps_vb = None
        if filtering:
            with open(verb_filter_file) as f:
                img_caps_vb = json.load(f)
        img_cap_v_2_class = None
        if det_filtering:
            with open(det_filter_file) as f:
                img_cap_v_2_class = json.load(f)

        for id_split, samples_split in enumerate(samples):
            for s in samples_split:
                id_image = str(int(s.image.split("/")[-1].split("_")[-1]
                                   .split(".")[0]))
                caption = s.text.lower().replace("\t", " ").replace("\n", "")
                if filtering and caption not in img_caps_vb.get(id_image, []):
                    continue
                if id_split == 2 and det_filtering:
                    if id_image not in img_cap_v_2_class:
                        continue
                    if caption not in img_cap_v_2_class[id_image]:
                        continue
                words = caption.strip().split(" ")
                caption_fixed = [w for w in words
                                 if w not in PUNCTUATIONS and w != ""]
                det_classes = [None for _ in caption_fixed]
                caption_fixed = " ".join(caption_fixed)
                for p in PUNCTUATIONS:
                    caption_fixed = caption_fixed.replace(p, "")

                if id_image not in visual_chunks:
                    continue
                if caption not in visual_chunks[id_image]:
                    continue
                chunks = visual_chunks[id_image][caption]
                for chunk in chunks:  # [words, class]
                    words = chunk[0].split(" ")
                    chunk_fixed = [w for w in words
                                   if w not in PUNCTUATIONS and w != ""]
                    chunk_fixed = " ".join(chunk_fixed)
                    for p in PUNCTUATIONS:
                        chunk_fixed = chunk_fixed.replace(p, "")
                    sub_str = " ".join(["_" for _ in chunk_fixed.split(" ")])
                    sub_cap = caption_fixed.replace(chunk_fixed,
                                                    sub_str).split(" ")
                    for i, w in enumerate(sub_cap):
                        if w == "_":
                            det_classes[i] = chunk[1]

                example = Example.fromdict({
                    "image": s.image,
                    "detection": ((s.image, caption), tuple(det_classes)),
                    "text": caption_fixed})

                det_classes_set = [x[0] for x in groupby(det_classes)
                                   if x[0] is not None]
                chunks_filtered = list(set(c[1] for c in chunks))
                if len(det_classes_set) < len(chunks_filtered):
                    continue
                if id_split == 0:
                    train_examples.append(example)
                elif id_split == 1:
                    if not (filtering and "_" in example.detection[1]):
                        val_examples.append(example)
                elif id_split == 2:
                    if not (filtering and "_" in example.detection[1]):
                        test_examples.append(example)

        return train_examples, val_examples, test_examples


# ---------------------------------------------------------------------------
# FlickrEntities (ref data/dataset.py:169-302)
# ---------------------------------------------------------------------------

_FLICKR_RE = re.compile(r"([^\[\]]*)(\[[^\[\]]+\])([^\[\]]*)")


class FlickrEntities(PairedDataset):
    def __init__(self, image_field, text_field, det_field, img_root,
                 ann_file, entities_root, verb_filter=False, det_filter=False,
                 verb_filter_file="datasets/flickr/cap_2_verb_nv.json",
                 det_filter_file="saved_data/flickr/img_cap_v_2_idbox_flickr.json",
                 precomp_file=None, precomputed_samples=None):
        if precomputed_samples is not None:
            self.train_examples, self.val_examples, self.test_examples = \
                precomputed_samples
        else:
            if precomp_file is None:
                if det_filter:
                    precomp_file = "saved_data/flickr/flickr_entities_precomp_df.pkl"
                elif verb_filter:
                    precomp_file = "saved_data/flickr/flickr_entities_precomp_vf.pkl"
                else:
                    precomp_file = "saved_data/flickr/flickr_entities_precomp.pkl"
            if os.path.isfile(precomp_file):
                with open(precomp_file, "rb") as f:
                    (self.train_examples, self.val_examples,
                     self.test_examples) = pickle.load(f)
            else:
                (self.train_examples, self.val_examples,
                 self.test_examples) = self.get_samples(
                    ann_file, img_root, entities_root, verb_filter,
                    det_filter, verb_filter_file, det_filter_file)

        examples = (self.train_examples + self.val_examples
                    + self.test_examples)
        super().__init__(examples, {"image": image_field,
                                    "detection": det_field,
                                    "text": text_field})

    @property
    def splits(self):
        return (PairedDataset(self.train_examples, self.fields),
                PairedDataset(self.val_examples, self.fields),
                PairedDataset(self.test_examples, self.fields))

    @staticmethod
    def parse_image(entities_root, img_root, filename, split):
        """Parse one image's Annotations XML + bracketed Sentences file
        (ref :197-256)."""
        xml_root = xml.etree.ElementTree.parse(
            os.path.join(entities_root, "Annotations",
                         filename.replace(".jpg", ".xml"))).getroot()
        det_dict: Dict[str, Dict] = {}
        id_counter = 1
        for obj in xml_root.findall("object"):
            obj_names = [o.text for o in obj.findall("name")]
            if obj.find("bndbox") is not None:
                bbox = tuple(int(o.text) for o in obj.find("bndbox"))
                for obj_name in obj_names:
                    if obj_name not in det_dict:
                        det_dict[obj_name] = {"id": id_counter,
                                              "bdnbox": [bbox]}
                        id_counter += 1
                    else:
                        det_dict[obj_name]["bdnbox"].append(bbox)

        bdnboxes: List = [[] for _ in range(id_counter - 1)]
        for it in det_dict.values():
            bdnboxes[it["id"] - 1] = tuple(it["bdnbox"])
        bdnboxes = tuple(bdnboxes)

        captions = [l.strip() for l in open(
            os.path.join(entities_root, "Sentences",
                         filename.replace(".jpg", ".txt")),
            encoding="utf-8").readlines()]
        outputs = []
        for c in captions:
            matches = _FLICKR_RE.findall(c)
            caption: List[str] = []
            det_ids: List[int] = []
            for match in matches:
                for i, grp in enumerate(match):
                    if i in (0, 2):
                        if grp != "":
                            for w in grp.strip().split(" "):
                                if w not in PUNCTUATIONS and w != "":
                                    caption.append(w)
                                    det_ids.append(0)
                    elif i == 1:
                        words = grp[1:-1].strip().split(" ")
                        obj_name = words[0].split("#")[-1].split("/")[0]
                        for w in words[1:]:
                            if w not in PUNCTUATIONS and w != "":
                                caption.append(w)
                                det_ids.append(
                                    det_dict[obj_name]["id"]
                                    if obj_name in det_dict else 0)
            caption = " ".join(caption)
            if caption != "" and np.sum(np.asarray(det_ids)) > 0:
                outputs.append([Example.fromdict({
                    "image": os.path.join(img_root, filename),
                    "detection": ((os.path.join(img_root, filename), caption),
                                  bdnboxes, det_ids),
                    "text": caption}), split])
        return outputs

    @classmethod
    def get_samples(cls, ann_file, img_root, entities_root, verb_filter=False,
                    det_filter=False, verb_filter_file=None,
                    det_filter_file=None):
        dataset = json.load(open(ann_file))["images"]
        samples = []
        for d in dataset:
            samples.extend(cls.parse_image(entities_root, img_root,
                                           d["filename"], d["split"]))

        cap_2_verb = img_cap_v_2_class = None
        if verb_filter:
            with open(verb_filter_file) as f:
                cap_2_verb = json.load(f)
        if det_filter:
            with open(det_filter_file) as f:
                img_cap_v_2_class = json.load(f)

        train_samples, val_samples, test_samples = [], [], []
        for example, split in samples:
            imgid = example.image.split("/")[-1].split(".")[0]
            caption = example.text
            if det_filter and split == "test":
                if imgid not in img_cap_v_2_class:
                    continue
                if caption not in img_cap_v_2_class[imgid]:
                    continue
            if verb_filter and cap_2_verb[imgid][caption] == []:
                continue
            if split == "train":
                train_samples.append(example)
            elif split == "val":
                val_samples.append(example)
            elif split == "test":
                test_samples.append(example)
        return train_samples, val_samples, test_samples
