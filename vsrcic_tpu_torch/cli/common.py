"""Shared CLI plumbing: world construction (real or synthetic), platform
selection, seeding.

A copy of `vsrcic_tpu/cli/common.py` without JAX: `--platform cpu` selects
the CPU and anything else the card (`resolve_device`), and
`data_parallel_mesh` raises for a nonzero count until multi-GPU is ported.

Flag names mirror the reference scripts (--batch_size, --sample_rl, --det,
--gt, --checkpoint_path, --start_from, --load_best ...; reference
coco_scripts/train.py:24-34, eval_coco.py:25-35).
"""
from __future__ import annotations

import argparse
import os
import random
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


def resolve_device(platform: Optional[str]):
    """The torch device the CLIs run on: `--platform cpu` selects the CPU,
    and anything else, or nothing, the CUDA card. Takes the place of the
    JAX CLIs' `force_platform` / `ensure_virtual_devices`. A missing card
    raises: the port never falls back to the CPU."""
    from vsrcic_tpu_torch.utils.device import resolve_device as _resolve
    return _resolve("cpu" if platform == "cpu" else None)


def data_parallel_mesh(n: int, params):
    """(None, params) when n == 0. Multi-GPU data parallelism is not ported
    yet (ROADMAP.md section 1, item 7), so any other n raises."""
    if not n:
        return None, params
    raise NotImplementedError(
        "--data_parallel %d: multi-GPU data parallelism is not ported yet "
        "(ROADMAP.md section 1, item 7); run with --data_parallel 0" % n)


def seed_all(seed: int = 1234):
    random.seed(seed)
    np.random.seed(seed)


def base_parser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--exp_name", default=defaults.get("exp_name", "exp"))
    p.add_argument("--dataset", default="coco", choices=["coco", "flickr"])
    p.add_argument("--batch_size", default=defaults.get("batch_size", 100),
                   type=int)
    p.add_argument("--nb_workers", default=0, type=int)
    p.add_argument("--checkpoint_path", default="saved_model", type=str)
    p.add_argument("--start_from", default=None, type=str)
    p.add_argument("--load_best", action="store_true")
    p.add_argument("--coco_root", default="datasets/coco", type=str)
    p.add_argument("--flickr_root", default="datasets/flickr", type=str)
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic data backend (no real data)")
    p.add_argument("--synthetic_images", default=24, type=int)
    p.add_argument("--feat_dim", default=2048, type=int)
    # captioner width knobs (reference hardcodes 1000/1000/512,
    # controllable_captioning.py:11 — defaults match; tiny values make the
    # CLI lifecycle testable on a CPU host, tests/test_cli_lifecycle.py)
    p.add_argument("--input_encoding_size", default=1000, type=int)
    p.add_argument("--rnn_size", default=1000, type=int)
    p.add_argument("--att_size", default=512, type=int)
    p.add_argument("--max_epochs", default=100, type=int)
    p.add_argument("--max_steps", default=None, type=int,
                   help="stop after N optimizer steps (smoke tests)")
    p.add_argument("--platform", default=None, type=str,
                   help="cpu runs on the CPU (tests); anything else, or "
                   "nothing, on the CUDA card")
    p.add_argument("--seed", default=1234, type=int)
    return p


@dataclass
class COCOWorld:
    """Everything the COCO pipelines need."""
    store: Any
    classes: Any
    img_shapes: Any
    vectors: Any
    verb_2_idx: Any
    idx_2_vs: Any
    cap_2_classes: Any
    cap_2_verb: Any
    idx_2_vs_v: Any
    cap_2_classes_v: Any
    cap_2_verb_v: Any
    idx_2_v_og: Any
    vocab_tv: Any
    verb_2_vob_all: Any
    img_cap_v_2_class_self: Any
    vlem_2_vog: Any
    splits: Any                # (train, val, test) example lists
    text_field: Any = None


@dataclass
class FlickrWorld:
    store: Any
    classes: Any
    img_shapes: Any
    vectors: Any
    flickr_verb_idx: Any
    idx_2_vs: Any
    cap_2_verb: Any
    cap_2_classes: Any
    idx_2_v_og: Any
    vocab_tv: Any
    verb_2_vob_all: Any
    img_cap_v_2_idbox: Any
    vlem_2_vog: Any
    splits: Any
    text_field: Any = None


def build_flickr_world(opt) -> FlickrWorld:
    from vsrcic_tpu_torch.text import TextField

    if opt.synthetic:
        from vsrcic_tpu_torch.data.synthetic_flickr import SyntheticFlickr
        syn = SyntheticFlickr(n_images=opt.synthetic_images,
                              n_val=max(2, opt.synthetic_images // 8),
                              n_test=max(2, opt.synthetic_images // 8),
                              feat_dim=opt.feat_dim, seed=opt.seed)
        tf = TextField(fix_length=20)
        train, val, test = syn.sample_splits
        tf.build_vocab([e.text for e in train + val], min_freq=1)
        return FlickrWorld(
            store=syn.store, classes=syn.classes, img_shapes=syn.img_shapes,
            vectors=syn.vectors, flickr_verb_idx=syn.flickr_verb_idx,
            idx_2_vs=syn.idx_2_vs, cap_2_verb=syn.cap_2_verb,
            cap_2_classes=syn.cap_2_classes, idx_2_v_og=syn.idx_2_v_og,
            vocab_tv=list(tf.vocab.itos),
            verb_2_vob_all=syn.verb_2_vob_all(tf),
            img_cap_v_2_idbox=syn.img_cap_v_2_idbox,
            vlem_2_vog=syn.vlem_2_vog,
            splits=syn.sample_splits, text_field=tf)

    import json
    from vsrcic_tpu_torch.data import HDF5FeatureStore
    from vsrcic_tpu_torch.data.dataset import FlickrEntities
    from vsrcic_tpu_torch.data.fields import RawField

    root = opt.flickr_root

    def j(name):
        with open(os.path.join(root, name)) as f:
            return json.load(f)

    store = HDF5FeatureStore(os.path.join(root, "flickr30k_detections.hdf5"))
    tf = TextField(fix_length=20)
    dataset = FlickrEntities(
        RawField(), RawField(), RawField(), img_root="",
        ann_file=os.path.join(root, "flickr30k_annotations.json"),
        entities_root=os.path.join(root, "Flickr30kEntities"))
    train, val, test = (dataset.train_examples, dataset.val_examples,
                        dataset.test_examples)
    tf.build_vocab([e.text for e in train + val], min_freq=5)
    return FlickrWorld(
        store=store,
        classes=os.path.join(root, "object_class_list.txt"),
        img_shapes=j("flickr_img_shapes.json"),
        vectors=os.path.join(root, "object_class_glove.pkl"),
        flickr_verb_idx=j("flickr_verb_idx.json"),
        idx_2_vs=j("idx_2_vs_flickr.json"),
        cap_2_verb=j("cap_2_verb_flickr.json"),
        cap_2_classes=j("cap_2_classes_flickr.json"),
        idx_2_v_og=j("idx_2_v_og_flickr.json"),
        vocab_tv=j("vocab_tv_flickr.json"),
        verb_2_vob_all=j("verb_2_vob_all_refine_flickr.json"),
        img_cap_v_2_idbox=j("../saved_data/flickr/img_cap_v_2_idbox_flickr.json")
        if os.path.isfile(os.path.join(
            root, "../saved_data/flickr/img_cap_v_2_idbox_flickr.json"))
        else {},
        vlem_2_vog=j("vlem_2_vog_flickr.json"),
        splits=(train, val, test), text_field=tf)


def build_world(opt):
    return (build_flickr_world(opt) if opt.dataset == "flickr"
            else build_coco_world(opt))


def build_coco_world(opt) -> COCOWorld:
    from vsrcic_tpu_torch.text import TextField

    if opt.synthetic:
        from vsrcic_tpu_torch.data import SyntheticCOCO
        syn = SyntheticCOCO(n_images=opt.synthetic_images,
                            n_val=max(2, opt.synthetic_images // 8),
                            n_test=max(2, opt.synthetic_images // 8),
                            feat_dim=opt.feat_dim, seed=opt.seed)
        tf = TextField(fix_length=20)
        train, val, test = syn.sample_splits
        tf.build_vocab([e.text for e in train + val], min_freq=1)
        return COCOWorld(
            store=syn.store, classes=syn.classes, img_shapes=syn.img_shapes,
            vectors=syn.vectors, verb_2_idx=syn.verb_2_idx,
            idx_2_vs=syn.idx_2_vs, cap_2_classes=syn.cap_2_classes,
            cap_2_verb=syn.cap_2_verb, idx_2_vs_v=syn.idx_2_vs_v,
            cap_2_classes_v=syn.cap_2_classes_v,
            cap_2_verb_v=syn.cap_2_verb_v, idx_2_v_og=syn.idx_2_v_og,
            vocab_tv=list(tf.vocab.itos),
            verb_2_vob_all=syn.verb_2_vob_all(tf),
            img_cap_v_2_class_self=syn.img_cap_v_2_class_self,
            vlem_2_vog=syn.vlem_2_vog,
            splits=syn.sample_splits, text_field=tf)

    # real data: reference file layout (eval_coco.py:43-67)
    import json
    from vsrcic_tpu_torch.data import HDF5FeatureStore, PackedFeatureStore
    from vsrcic_tpu_torch.data.dataset import COCOEntities
    from vsrcic_tpu_torch.data.fields import RawField

    root = opt.coco_root
    packed = os.path.join(root, "coco_detections_packed")
    if os.path.isdir(packed):
        store = PackedFeatureStore(packed)
    else:
        store = HDF5FeatureStore(os.path.join(root, "coco_detections.hdf5"))

    def j(name):
        path = os.path.join(root, name)
        with open(path) as f:
            return json.load(f)

    tf = TextField(fix_length=20)
    entities = os.path.join(root, "coco_entities.json")
    dataset = COCOEntities(RawField(), RawField(), RawField(), img_root="",
                           ann_root=os.path.join(root, "annotations"),
                           entities_file=entities,
                           id_root=os.path.join(root, "annotations"))
    train, val, test = (dataset.train_examples, dataset.val_examples,
                        dataset.test_examples)
    tf.build_vocab([e.text for e in train + val], min_freq=5)
    return COCOWorld(
        store=store,
        classes=os.path.join(root, "object_class_list.txt"),
        img_shapes=j("coco_img_shapes.json"),
        vectors=os.path.join(root, "object_class_glove.pkl"),
        verb_2_idx=j("verb_2_idx.json"),
        idx_2_vs=j("idx_2_vs.json"),
        cap_2_classes=j("cap_2_classes.json"),
        cap_2_verb=j("cap_2_verb.json"),
        idx_2_vs_v=j("idx_2_vs_v.json"),
        cap_2_classes_v=j("cap_2_classes_v.json"),
        cap_2_verb_v=j("cap_2_verb_v.json"),
        idx_2_v_og=j("idx_2_v_og.json"),
        vocab_tv=j("vocab_tv.json"),
        verb_2_vob_all=j("verb_2_vob_all_refine.json"),
        img_cap_v_2_class_self=j("../saved_data/coco/img_cap_v_2_class_self.json")
        if os.path.isfile(os.path.join(
            root, "../saved_data/coco/img_cap_v_2_class_self.json")) else {},
        vlem_2_vog=j("vlem_2_vog_coco.json"),
        splits=(train, val, test), text_field=tf)
