"""Dataset-dispatching field factories for the CLIs.

A copy of `vsrcic_tpu/cli/fields.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

Field choices mirror the reference scripts exactly:
  COCO eval: COCOControlSetField_Verb / COCODetSetField_Verb (eval_coco.py:45-67)
  Flickr eval: FlickrControlSetField_Verb / FlickrDetSetField_Verb (eval_flickr.py:45-67)
  COCO S-SSP train: COCOControlSetField_Verb (train_region_sort.py:59)
  Flickr S-SSP train: FlickrControlSetField_Verb(visual=False) (train_region_sort_flickr.py:57-67)
  COCO Sinkhorn train: COCOControlSetField (train_sinkhorn.py:45)
  Flickr Sinkhorn train: FlickrControlSetField_Verb(visual=True) (train_sinkhorn_flickr.py:57-67)
"""
from __future__ import annotations



def make_image_field(world, opt):
    if opt.dataset == "flickr":
        from vsrcic_tpu_torch.data import FlickrDetectionField
        return FlickrDetectionField(world.store, diverse=True)
    from vsrcic_tpu_torch.data import ImageDetectionsField
    return ImageDetectionsField(world.store, max_detections=100)


def make_eval_det_field(world, opt):
    if opt.dataset == "flickr":
        from vsrcic_tpu_torch.data import (FlickrControlSetField_Verb,
                                     FlickrDetSetField_Verb)
        if not opt.det:
            return FlickrControlSetField_Verb(
                world.store, classes_path=world.classes,
                img_shapes_path=world.img_shapes,
                precomp_glove_path=world.vectors,
                verb_idx_path=world.flickr_verb_idx,
                idx_vs_path=world.idx_2_vs, cap_verb_path=world.cap_2_verb,
                cap_classes_path=world.cap_2_classes,
                idx_v_og_path=world.idx_2_v_og,
                vocab_list_path=world.vocab_tv,
                fix_length=opt.fixed_len, gt_verb=opt.gt)
        return FlickrDetSetField_Verb(
            world.store, classes_path=world.classes,
            img_shapes_path=world.img_shapes,
            precomp_glove_path=world.vectors,
            verb_idx_path=world.flickr_verb_idx, verb_vob_path={},
            idbox_seq_path=world.img_cap_v_2_idbox,
            vocab_list_path=world.vocab_tv,
            vlem_2_verb_og_path=world.vlem_2_vog,
            fix_length=opt.fixed_len, gt_verb=opt.gt)
    from vsrcic_tpu_torch.data import (COCOControlSetField_Verb,
                                 COCODetSetField_Verb)
    if not opt.det:
        return COCOControlSetField_Verb(
            world.store, classes_path=world.classes,
            img_shapes_path=world.img_shapes,
            precomp_glove_path=world.vectors, verb_idx_path=world.verb_2_idx,
            idx_vs_path=world.idx_2_vs_v,
            cap_classes_path=world.cap_2_classes_v,
            cap_verb_path=world.cap_2_verb_v, vocab_path=world.vocab_tv,
            idx_2_verb_og_path=world.idx_2_v_og, verb_vob_path={},
            fix_length=opt.fixed_len, max_detections=20, gt_verb=opt.gt)
    return COCODetSetField_Verb(
        world.store, cls_seq_path=world.img_cap_v_2_class_self,
        vocab_path=world.vocab_tv, vlem_2_v_og_path=world.vlem_2_vog,
        verb_idx_path=world.verb_2_idx, classes_path=world.classes,
        img_shapes_path=world.img_shapes, precomp_glove_path=world.vectors,
        fix_length=opt.fixed_len, max_detections=20, gt_verb=opt.gt)


def make_ssp_det_field(world, opt, fix_length=10):
    if opt.dataset == "flickr":
        from vsrcic_tpu_torch.data import FlickrControlSetField_Verb
        return FlickrControlSetField_Verb(
            world.store, classes_path=world.classes,
            img_shapes_path=world.img_shapes,
            precomp_glove_path=world.vectors,
            verb_idx_path=world.flickr_verb_idx, idx_vs_path=world.idx_2_vs,
            cap_verb_path=world.cap_2_verb,
            cap_classes_path=world.cap_2_classes,
            idx_v_og_path=world.idx_2_v_og, vocab_list_path=world.vocab_tv,
            fix_length=fix_length, visual=False)
    from vsrcic_tpu_torch.data import COCOControlSetField_Verb
    return COCOControlSetField_Verb(
        world.store, classes_path=world.classes,
        img_shapes_path=world.img_shapes, precomp_glove_path=world.vectors,
        verb_idx_path=world.verb_2_idx, idx_vs_path=world.idx_2_vs_v,
        cap_classes_path=world.cap_2_classes_v,
        cap_verb_path=world.cap_2_verb_v, vocab_path=world.vocab_tv,
        idx_2_verb_og_path=world.idx_2_v_og, verb_vob_path={},
        fix_length=fix_length, max_detections=20)


def make_sinkhorn_det_field(world, opt, fix_length=10):
    if opt.dataset == "flickr":
        from vsrcic_tpu_torch.data import FlickrControlSetField_Verb
        return FlickrControlSetField_Verb(
            world.store, classes_path=world.classes,
            img_shapes_path=world.img_shapes,
            precomp_glove_path=world.vectors,
            verb_idx_path=world.flickr_verb_idx, idx_vs_path=world.idx_2_vs,
            cap_verb_path=world.cap_2_verb,
            cap_classes_path=world.cap_2_classes,
            idx_v_og_path=world.idx_2_v_og, vocab_list_path=world.vocab_tv,
            fix_length=fix_length, visual=True)
    from vsrcic_tpu_torch.data import COCOControlSetField
    return COCOControlSetField(
        world.store, classes_path=world.classes,
        img_shapes_path=world.img_shapes, precomp_glove_path=world.vectors,
        verb_idx_path=world.verb_2_idx, idx_vs_path=world.idx_2_vs,
        cap_classes_path=world.cap_2_classes, cap_verb_path=world.cap_2_verb,
        fix_length=fix_length, max_detections=20)


def unpack_eval_output(out, dataset: str, det: bool):
    """Field output tuple -> (word, vis, pos, vis_all, seq_v, seq_sr,
    control_verb, verb_list)."""
    if dataset == "flickr":
        if not det:   # 11 outputs (visual _Verb)
            word, vis, pos, vis_all, seq_v, seq_sr, cv, _, _, _, vl = out
        else:         # 8 outputs
            word, vis, pos, vis_all, seq_v, seq_sr, cv, vl = out
    else:
        if not det:   # 11 outputs
            word, vis, pos, vis_all, seq_v, seq_sr, cv, _, _, _, vl = out
        else:         # 9 outputs
            word, vis, pos, vis_all, seq_v, seq_sr, cv, _, vl = out
    return word, vis, pos, vis_all, seq_v, seq_sr, cv, vl
