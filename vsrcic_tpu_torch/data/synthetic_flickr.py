"""Synthetic Flickr30k-Entities-shaped fixtures (mirror of synthetic.py).

A copy of `vsrcic_tpu/data/synthetic_flickr.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

Fabricates the Flickr side-table schemas (reference
flickr_scripts/eval_flickr.py:43-67): integer entity-class sequences
(cap_2_classes with the +1 offset the field strips), per-entity GT bboxes,
numeric SR ids, `verb_occ`-keyed verb tables with the 10000*occurrence
encoding, and the detected-region idbox tables.
"""
from __future__ import annotations

import numpy as np

from vsrcic_tpu_torch.data.dataset import Example
from vsrcic_tpu_torch.data.synthetic import ClassSeededStore


class SyntheticFlickr:
    def __init__(self, n_images=12, n_val=3, n_test=3, n_classes=16,
                 n_verbs=8, feat_dim=2048, seed=0):
        rng = np.random.RandomState(seed)
        self.feat_dim = feat_dim
        self.class_names = ["thing%d" % i for i in range(n_classes)]
        self.classes = ["__background__"] + self.class_names
        self.verbs = ["verb%d" % i for i in range(n_verbs)]
        self.flickr_verb_idx = {v: i for i, v in enumerate(self.verbs)}
        self.vectors = {c: rng.randn(300).astype(np.float32)
                        for c in self.class_names}

        self.img_shapes = {}
        self.idx_2_vs = {}
        self.cap_2_verb = {}
        self.cap_2_classes = {}
        self.idx_2_v_og = {}
        self.img_cap_v_2_idbox = {}
        self.vlem_2_vog = {}
        self.cap_2_verb_nv = {}
        image_classes = {}
        splits = {"train": [], "val": [], "test": []}

        n_total = n_images + n_val + n_test
        for i in range(n_total):
            img_id = "20%07d" % i
            image = "flickr30k_images/%s.jpg" % img_id
            self.img_shapes[img_id] = [500, 375]
            multi = (i % 3 == 2)   # repeated-SR case — see synthetic.py
            n_ents = 3 if multi else 2
            # class choice drawn BEFORE the verb to keep the original rng
            # stream for 2-entity images (content-pinning tests rely on
            # image 0's entity boxes landing on distinct detections)
            chosen = rng.choice(n_classes, n_ents, replace=False)
            verb = self.verbs[rng.randint(n_verbs)]
            verb_occ = verb + "_0"
            verb_og = verb + "s"
            names = [self.class_names[c] for c in chosen]
            image_classes[img_id] = [int(c) + 1 for c in chosen]

            # GT entities with boxes; entity ids 1..n in det_ids space
            boxes = []
            for _ in range(n_ents):
                x1, y1 = rng.rand() * 200, rng.rand() * 150
                boxes.append(((int(x1), int(y1), int(x1) + 80,
                               int(y1) + 80),))
            bdnboxes = tuple(boxes)

            if multi:
                # "a X and a Y verbs a Z": X and Y share SR 1 (ARG0)
                caption = "a %s and a %s %s a %s" % (names[0], names[1],
                                                     verb_og, names[2])
                det_ids = [0, 1, 0, 0, 2, 0, 0, 3]
                cap_cls = [1, 2, -1, 3]
                vs = {"verb": [[verb_occ]] * 4,
                      "sr": [[1], [1], [25], [2]]}
                v_og = [[verb_og]] * 4
                idbox = {verb_occ: {"1": [0, 1], "2": [2]}}
            else:
                caption = "a %s %s a %s" % (names[0], verb_og, names[1])
                det_ids = [0, 1, 0, 0, 2]  # word-aligned ("a X vs a Y")
                # cap_2_classes: +1-offset ints; verb position encoded so
                # that x-1 < 0 (the field treats negatives as verb slots)
                cap_cls = [1, -1, 2]
                vs = {"verb": [[verb_occ], [verb_occ], [verb_occ]],
                      "sr": [[1], [25], [2]]}    # ARG0, V, ARG1 (numeric)
                v_og = [[verb_og], [verb_og], [verb_og]]
                idbox = {verb_occ: {"1": [0], "2": [1]}}

            self.cap_2_classes.setdefault(img_id, {})[caption] = cap_cls
            self.idx_2_vs.setdefault(img_id, {})[caption] = vs
            self.cap_2_verb.setdefault(img_id, {})[caption] = [verb_occ]
            self.idx_2_v_og.setdefault(img_id, {})[caption] = v_og
            self.img_cap_v_2_idbox.setdefault(img_id, {})[caption] = idbox
            self.vlem_2_vog.setdefault(img_id, {})[caption] = \
                [[verb, verb_og]]
            self.cap_2_verb_nv.setdefault(img_id, {})[caption] = [verb_occ]

            split = ("train" if i < n_images else
                     "val" if i < n_images + n_val else "test")
            splits[split].append(Example.fromdict({
                "image": image,
                "detection": ((image, caption), bdnboxes, det_ids),
                "text": caption}))

        self.store = ClassSeededStore(image_classes, len(self.classes),
                                      feat_dim=feat_dim, seed=seed)
        self.sample_splits = (splits["train"], splits["val"], splits["test"])

    def vocab_tv(self, text_field):
        return list(text_field.vocab.itos)

    def verb_2_vob_all(self, text_field):
        table = {}
        for verb, idx in self.flickr_verb_idx.items():
            ids = []
            for form in (verb, verb + "s"):
                if form in text_field.vocab.stoi:
                    ids.append(text_field.vocab.stoi[form])
            table[str(idx + 1)] = ids
        return table
