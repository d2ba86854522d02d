"""Synthetic COCO-Entities-shaped fixture generator.

A copy of `vsrcic_tpu/data/synthetic.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

The reference accidentally supports running without real data via its
missing-HDF5 fallback (SURVEY.md §4); here that affordance is a first-class
backend: a deterministic generator that fabricates a mutually-consistent set
of detections, entity alignments, SRL tables and captions with exactly the
schemas the fields expect (reference side tables listed at
coco_scripts/eval_coco.py:43-67). Used by tests, the CLIs' `--synthetic`
mode, and the benchmark harness.
"""
from __future__ import annotations

import numpy as np

from vsrcic_tpu_torch.data.store import DetRecord
from vsrcic_tpu_torch.data.dataset import COCOEntities, Example

SR_NAMES = ["ARG0", "ARG1", "ARG2", "LOC", "MNR", "TMP"]


class ClassSeededStore:
    """Detection store whose per-image class argmaxes hit prescribed classes.

    Features are class prototypes + noise so that visual grounding is
    actually learnable on synthetic data (a detection's feature vector
    carries its class identity, like real Faster-R-CNN features do).
    """

    def __init__(self, image_classes, n_classes, feat_dim=2048, n_dets=10,
                 seed=0, noise=0.15):
        self.image_classes = image_classes  # {str(id): [class indices >=1]}
        self.n_classes = n_classes
        self.feat_dim = feat_dim
        self.n_dets = n_dets
        self.seed = seed
        self.noise = noise
        proto_rng = np.random.RandomState(seed + 777)
        self._protos = proto_rng.rand(n_classes, feat_dim).astype(np.float32)

    def get(self, image_id):
        key = str(image_id)
        # stable per-key seed: builtin hash() of a str is randomized per
        # PROCESS (PYTHONHASHSEED), which made synthetic detections differ
        # between runs — a flaky-test source caught in round 4
        import zlib
        rng = np.random.RandomState(
            (zlib.crc32(key.encode()) + self.seed) % (2 ** 31))
        cls_list = self.image_classes.get(key, [1])
        n = self.n_dets
        probs = rng.rand(n, self.n_classes).astype(np.float32) * 0.1
        det_cls = [cls_list[i % len(cls_list)] for i in range(n)]
        for i, c in enumerate(det_cls):
            probs[i, c] = 1.0
        feats = (self._protos[det_cls]
                 + self.noise * rng.rand(n, self.feat_dim)
                 ).astype(np.float32)
        x1 = rng.rand(n, 1) * 200
        y1 = rng.rand(n, 1) * 200
        boxes = np.concatenate(
            [x1, y1, x1 + 20 + rng.rand(n, 1) * 80,
             y1 + 20 + rng.rand(n, 1) * 80], 1).astype(np.float32)
        return DetRecord(probs, feats, boxes)


class SyntheticCOCO:
    """All side tables + examples for the COCO pipelines, fabricated."""

    def __init__(self, n_images=12, n_val=3, n_test=3, n_classes=16,
                 n_verbs=8, feat_dim=2048, seed=0):
        rng = np.random.RandomState(seed)
        self.feat_dim = feat_dim
        self.class_names = ["thing%d" % i for i in range(n_classes)]
        self.classes = ["__background__"] + self.class_names
        self.verbs = ["verb%d" % i for i in range(n_verbs)]
        self.verb_2_idx = {v: i for i, v in enumerate(self.verbs)}
        self.vectors = {c: rng.randn(300).astype(np.float32)
                        for c in self.class_names}

        self.img_shapes = {}
        self.entities = {}
        self.idx_2_vs = {}          # non-verb variant (classes only)
        self.cap_2_classes = {}
        self.cap_2_verb = {}
        self.idx_2_vs_v = {}        # _v variant ('verb' tokens included)
        self.cap_2_classes_v = {}
        self.cap_2_verb_v = {}
        self.idx_2_v_og = {}
        self.img_caps_vb = {}
        self.img_cap_v_2_class_self = {}
        self.vlem_2_vog = {}
        image_classes = {}
        samples = {"train": [], "val": [], "test": []}

        n_total = n_images + n_val + n_test
        for i in range(n_total):
            img_id = 100000 + i
            key = str(img_id)
            image = "images/COCO_synth_%012d.jpg" % img_id
            self.img_shapes[key] = [640, 480]
            verb = self.verbs[rng.randint(n_verbs)]
            verb_og = verb + "s"
            verbs_here = [verb]                     # multi-verb branch
            vlem_here = [[verb, verb_og]]           # overrides these
            if i % 3 == 2:
                # every 3rd image: TWO entities share ARG0 ("a X and a Y
                # verbs a Z") — the repeated-SR (need_re_rank) case real
                # entities data has; without it Sinkhorn training/eval
                # re-ranking silently never fires on the synthetic backend
                c1, c1b, c2 = rng.choice(n_classes, 3, replace=False)
                cls1, cls1b, cls2 = (self.class_names[c1],
                                     self.class_names[c1b],
                                     self.class_names[c2])
                caption = "a %s and a %s %s a %s" % (cls1, cls1b, verb_og,
                                                     cls2)
                image_classes[key] = [c1 + 1, c1b + 1, c2 + 1]
                self.entities.setdefault(key, {})[caption] = [
                    ["a %s" % cls1, cls1], ["a %s" % cls1b, cls1b],
                    ["a %s" % cls2, cls2]]
                self.cap_2_classes.setdefault(key, {})[caption] = \
                    [cls1, cls1b, cls2]
                self.idx_2_vs.setdefault(key, {})[caption] = {
                    "verb": [[verb], [verb], [verb]],
                    "sr": [["ARG0"], ["ARG0"], ["ARG1"]]}
                self.cap_2_classes_v.setdefault(key, {})[caption] = \
                    [cls1, cls1b, "verb", cls2]
                self.idx_2_vs_v.setdefault(key, {})[caption] = {
                    "verb": [[verb]] * 4,
                    "sr": [["ARG0"], ["ARG0"], ["V"], ["ARG1"]]}
                self.idx_2_v_og.setdefault(key, {})[caption] = \
                    [[verb_og]] * 4
                self.img_cap_v_2_class_self.setdefault(key, {})[caption] = {
                    verb: {"ARG0": [int(c1 + 1), int(c1b + 1)],
                           "ARG1": [int(c2 + 1)]}}
            elif i % 5 == 4:
                # every 5th (non-colliding) image: TWO verbs — the only
                # source of multi-verb jobs, whose final rank goes through
                # the order-preserving verb_rank_merge (otherwise that
                # eval-pipeline branch never fires outside fuzz tests)
                verb2 = self.verbs[(self.verb_2_idx[verb] + 1) % n_verbs]
                verb2_og = verb2 + "s"
                c1, c2, c3 = rng.choice(n_classes, 3, replace=False)
                cls1, cls2, cls3 = (self.class_names[c1],
                                    self.class_names[c2],
                                    self.class_names[c3])
                caption = "a %s %s a %s and %s a %s" % (
                    cls1, verb_og, cls2, verb2_og, cls3)
                image_classes[key] = [c1 + 1, c2 + 1, c3 + 1]
                self.entities.setdefault(key, {})[caption] = [
                    ["a %s" % cls1, cls1], ["a %s" % cls2, cls2],
                    ["a %s" % cls3, cls3]]
                self.cap_2_classes.setdefault(key, {})[caption] = \
                    [cls1, cls2, cls3]
                self.idx_2_vs.setdefault(key, {})[caption] = {
                    "verb": [[verb, verb2], [verb], [verb2]],
                    "sr": [["ARG0", "ARG0"], ["ARG1"], ["ARG1"]]}
                self.cap_2_classes_v.setdefault(key, {})[caption] = \
                    [cls1, "verb", cls2, "verb", cls3]
                self.idx_2_vs_v.setdefault(key, {})[caption] = {
                    "verb": [[verb, verb2], [verb], [verb], [verb2],
                             [verb2]],
                    "sr": [["ARG0", "ARG0"], ["V"], ["ARG1"], ["V"],
                           ["ARG1"]]}
                self.idx_2_v_og.setdefault(key, {})[caption] = [
                    [verb_og, verb2_og], [verb_og], [verb_og],
                    [verb2_og], [verb2_og]]
                self.img_cap_v_2_class_self.setdefault(key, {})[caption] = {
                    verb: {"ARG0": [int(c1 + 1)], "ARG1": [int(c2 + 1)]},
                    verb2: {"ARG0": [int(c1 + 1)], "ARG1": [int(c3 + 1)]}}
                verbs_here = [verb, verb2]
                vlem_here = [[verb, verb_og], [verb2, verb2_og]]
            else:
                c1, c2 = rng.choice(n_classes, 2, replace=False)
                cls1, cls2 = self.class_names[c1], self.class_names[c2]
                caption = "a %s %s a %s" % (cls1, verb_og, cls2)
                image_classes[key] = [c1 + 1, c2 + 1]
                self.entities.setdefault(key, {})[caption] = [
                    ["a %s" % cls1, cls1], ["a %s" % cls2, cls2]]
                # classes-only control sequence (D7 schema)
                self.cap_2_classes.setdefault(key, {})[caption] = \
                    [cls1, cls2]
                self.idx_2_vs.setdefault(key, {})[caption] = {
                    "verb": [[verb], [verb]],
                    "sr": [["ARG0"], ["ARG1"]]}
                # verb-slot variants (D9/D10): 'verb' token in the middle
                self.cap_2_classes_v.setdefault(key, {})[caption] = \
                    [cls1, "verb", cls2]
                self.idx_2_vs_v.setdefault(key, {})[caption] = {
                    "verb": [[verb], [verb], [verb]],
                    "sr": [["ARG0"], ["V"], ["ARG1"]]}
                self.idx_2_v_og.setdefault(key, {})[caption] = \
                    [[verb_og], [verb_og], [verb_og]]
                self.img_cap_v_2_class_self.setdefault(key, {})[caption] = {
                    verb: {"ARG0": [int(c1 + 1)], "ARG1": [int(c2 + 1)]}}
            self.cap_2_verb.setdefault(key, {})[caption] = verbs_here
            self.cap_2_verb_v.setdefault(key, {})[caption] = \
                list(verbs_here)
            self.img_caps_vb.setdefault(key, []).append(caption)
            self.vlem_2_vog.setdefault(key, {})[caption] = vlem_here

            split = ("train" if i < n_images else
                     "val" if i < n_images + n_val else "test")
            samples[split].append(Example.fromdict(
                {"image": image, "text": caption}))

        self.store = ClassSeededStore(image_classes, len(self.classes),
                                      feat_dim=feat_dim, seed=seed)
        # run the REAL entities-alignment code on the synthetic tables
        self.sample_splits = COCOEntities.get_samples(
            (samples["train"], samples["val"], samples["test"]),
            self.entities, filtering=False)

    # ------------------------------------------------------------------
    def vocab_tv(self, text_field):
        """Caption vocab list (vocab_tv.json analog) after vocab build."""
        return list(text_field.vocab.itos)

    def verb_2_vob_all(self, text_field):
        """{str(verb_idx+1): [caption-vocab ids of tenses]} — the table the
        captioner's step_v consults (ref controllable_captioning.py:26-27)."""
        table = {}
        for verb, idx in self.verb_2_idx.items():
            ids = []
            for form in (verb, verb + "s"):
                if form in text_field.vocab.stoi:
                    ids.append(text_field.vocab.stoi[form])
            table[str(idx + 1)] = ids
        return table

    def all_captions(self):
        caps = []
        for per_img in self.cap_2_classes.values():
            caps.extend(per_img.keys())
        return caps
