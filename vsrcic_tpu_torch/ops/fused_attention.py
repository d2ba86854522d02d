"""Fused region-group gather + sentinel attention + shift-gate evidence.

Counterpart of `vsrcic_tpu/ops/fused_attention.py`. For each decode row r,
with the group ``det = det_groups[item[r], ctrl[r]]`` (M x D) and its
projection ``proj = groups_proj[item[r], ctrl[r]]`` (M x A) taken from
per-item tables that are not expanded per beam:

    det_w   = tanh(proj + ha) @ att_a                    (M,)
    mask    = rowsum(det) != 0                           (M,)
    att     = exp([sent_w ; det_w] - max) * [sent_mask ; mask]; att /= sum
    att_det = att[0] * fc_sentinel + att[1:] @ det       (D,)
    g_evid  = sum(mask * det_w)                          (1,)

`fused_group_attention_plain` is the plain PyTorch version. The wrapper
`fused_group_attention` runs it for CPU tensors and launches the CUDA kernel
(`csrc/fused_attention.cu`) for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import torch

from vsrcic_tpu_torch.ops import _build


def fused_group_attention_plain(item, ctrl, ha, sent_w, sent_mask,
                                fc_sentinel, att_a_vec, det_groups,
                                groups_proj):
    """Plain version. Tables (B, L, M, D) / (B, L, M, A) in bf16 or f32;
    returns (att_detections (rows, D) f32, gate_evidence (rows, 1) f32)."""
    item = item.long()
    ctrl = ctrl.long()
    det = det_groups[item, ctrl].float()                  # (rows, M, D)
    proj = groups_proj[item, ctrl].float()                # (rows, M, A)
    mask = (det.sum(-1, keepdim=True) != 0).float()       # (rows, M, 1)
    det_w = (torch.tanh(proj + ha[:, None, :]) * att_a_vec).sum(
        -1, keepdim=True)                                 # (rows, M, 1)
    mx = torch.maximum(det_w[:, :, 0].amax(-1, keepdim=True), sent_w)
    att_det = torch.exp(det_w - mx[:, :, None]) * mask
    att_sent = torch.exp(sent_w - mx) * sent_mask         # (rows, 1)
    denom = att_det[:, :, 0].sum(-1, keepdim=True) + att_sent
    att_det = att_det / denom[:, :, None]
    att_sent = att_sent / denom
    out = (att_det * det).sum(1) + att_sent * fc_sentinel
    gsum = (mask * det_w)[:, :, 0].sum(-1, keepdim=True)
    return out, gsum


def fused_group_attention(item, ctrl, ha, sent_w, sent_mask, fc_sentinel,
                          att_a_vec, det_groups, groups_proj):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors.

    item, ctrl: (rows,) int32 indices into the tables' first two axes (the
    kernel writes NaN for a row whose indices are out of range). Any rows,
    M, D and A."""
    if ha.device.type == "cpu":
        return fused_group_attention_plain(
            item, ctrl, ha, sent_w, sent_mask, fc_sentinel, att_a_vec,
            det_groups, groups_proj)
    if ha.device.type != "cuda":
        raise ValueError("fused_group_attention: unsupported device %s"
                         % ha.device)
    dev = ha.device
    b, l, m, d = det_groups.shape
    a = groups_proj.shape[-1]
    rows = ha.shape[0]
    tdt = det_groups.dtype
    if tdt not in (torch.float32, torch.bfloat16):
        raise ValueError("tables must be float32 or bfloat16, got %s" % tdt)
    f32 = torch.float32
    for t, name, shape, dtype in (
            (item, "item", (rows,), torch.int32),
            (ctrl, "ctrl", (rows,), torch.int32),
            (ha, "ha", (rows, a), f32),
            (sent_w, "sent_w", (rows, 1), f32),
            (sent_mask, "sent_mask", (rows, 1), f32),
            (fc_sentinel, "fc_sentinel", (rows, d), f32),
            (att_a_vec, "att_a_vec", (a,), f32),
            (det_groups, "det_groups", (b, l, m, d), tdt),
            (groups_proj, "groups_proj", (b, l, m, a), tdt)):
        _build.check_tensor(t, name, shape, dtype, dev)
    out = torch.empty((rows, d), dtype=f32, device=dev)
    gsum = torch.empty((rows, 1), dtype=f32, device=dev)
    if rows == 0:
        return out, gsum
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vsrcic_fused_attention(
        item.data_ptr(), ctrl.data_ptr(), ha.data_ptr(), sent_w.data_ptr(),
        sent_mask.data_ptr(), fc_sentinel.data_ptr(), att_a_vec.data_ptr(),
        det_groups.data_ptr(), groups_proj.data_ptr(),
        int(tdt == torch.bfloat16), rows, b, l, m, d, a,
        out.data_ptr(), gsum.data_ptr(), stream)
    _build.check(err, "fused_group_attention")
    fused_group_attention.launches += 1
    return out, gsum


fused_group_attention.launches = 0
