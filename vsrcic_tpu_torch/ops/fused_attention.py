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
`fused_launch_plan` chooses the kernel's cluster size, rows per run, slice
widths and shared bytes.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from vsrcic_tpu_torch.ops import _build

SMS = 132                # streaming multiprocessors of an H100 SXM (default)
SMEM_MAX = 232_448       # dynamic shared bytes one block may use
SMEM_SM = 233_472        # shared bytes of one SM that blocks may hold
SMEM_RESERVED = 1_024    # shared bytes the runtime keeps per block
WARPS = 8                # warps per block (csrc kThreads / 32)
MAX_BATCH = 8            # rows per barrier round at most (csrc kMaxBatch)
MAX_RUN = 256 - MAX_BATCH - 1  # a run's window (one thread a row) fits 256
MIN_BLOCKS = 3           # blocks per SM its registers allow (csrc kMinBlocks)
CLUSTERS = (2, 4, 8)     # cluster sizes tried, smallest first
BATCHES = (8, 4, 2, 1)   # rows per barrier round, tried largest first
RUNS_PER_SLOT = 4        # runs per resident block slot (shorter runs)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    cluster: int         # blocks per cluster: D and A are split this many ways
    rows_per_run: int    # consecutive rows one cluster takes
    runs: int            # clusters in the grid
    batch: int           # rows per barrier round
    d_slice: int         # D columns per block (the last block takes the rest)
    a_slice: int         # A columns per block
    box_d: int           # D columns per TMA box (a slice is whole boxes)
    box_a: int           # A columns per TMA box
    smem_bytes: int      # dynamic shared bytes per block
    bulk: bool           # TMA boxes (else element copies, one box a slice)


def _up(x, k):
    return -(-x // k) * k


def _box(width, vec):
    """The widest TMA box (<= 256 columns, a multiple of `vec`) that divides
    a slice `width` columns wide."""
    return max(b for b in range(vec, min(width, 256) + 1, vec)
               if width % b == 0)


def _smem_bytes(m, dw, aw, bd, ba, table_bytes, run, batch, cluster):
    """Dynamic shared bytes of one block: csrc/fused_attention.cu's
    `make_layout`, which refuses any other figure."""
    n = (dw // bd * _up(m * bd * table_bytes, 128)
         + aw // ba * _up(m * ba * table_bytes, 128))  # the group's slices
    n += 4 * batch * _up(aw, 4) + 4 * 4 * batch   # ha, sentinel scalars
    n = _up(n + 4 * _up(aw, 4), 16)               # att_a slice
    n += 4 * 2 * cluster * (batch + 1) * m        # partial det_w, row sums
    n += 4 * (2 * batch * m + batch)              # weights, mask, sentinel
    window = run + MAX_BATCH + 1
    return _up(_up(n, 16) + 24 * window + 4 * (2 * WARPS + 2), 16) + 16


@functools.lru_cache(maxsize=256)
def fused_launch_plan(rows, m, d, a, table_bytes, aligned=True, sms=SMS):
    """The kernel's launch for `rows` rows over (B, L, m, d) / (B, L, m, a)
    tables of `table_bytes`-byte elements on a card of `sms` SMs. Of the
    cluster sizes in CLUSTERS and the batches of BATCHES whose blocks fit
    shared memory, it takes the one that fits the most blocks on an SM (up
    to MIN_BLOCKS), then the smallest cluster, then the largest batch; then
    runs of consecutive rows short enough to give each resident block
    RUNS_PER_SLOT runs. The copies are TMA boxes when rows are whole
    16-byte units, M <= 256 and the tensors are `aligned` to 16 bytes, else
    element copies. Raises ValueError when nothing fits."""
    return _plan(rows, m, d, a, table_bytes, aligned, sms)


def _plan(rows, m, d, a, table_bytes, aligned, sms, cluster=None,
          batch=None, run=None):
    """`fused_launch_plan`, or with its cluster, batch or run fixed (the
    plan sweep of tools/ab_fused.py)."""
    if (min(rows, m, d, a, sms) < 1 or table_bytes not in (2, 4)
            or (batch is not None and not 1 <= batch <= MAX_BATCH)):
        raise ValueError("fused_launch_plan: rows %d, M %d, D %d, A %d, "
                         "table bytes %d, SMs %d, batch %s"
                         % (rows, m, d, a, table_bytes, sms, batch))
    vec = 16 // table_bytes
    bulk = aligned and d % vec == 0 and a % vec == 0 and m <= 256
    align = vec if bulk else 1
    fits = []
    for c in ((cluster,) if cluster else CLUSTERS):
        dw = _up(math.ceil(d / c), align)
        aw = _up(math.ceil(a / c), align)
        bd, ba = (_box(dw, vec), _box(aw, vec)) if bulk else (dw, aw)
        for p in ((batch,) if batch else BATCHES):
            smem = _smem_bytes(m, dw, aw, bd, ba, table_bytes, 1, p, c)
            if smem <= SMEM_MAX:
                per_sm = min(MIN_BLOCKS, SMEM_SM // (smem + SMEM_RESERVED))
                fits.append((-per_sm, c, -p, dw, aw, bd, ba))
    if not fits:
        raise ValueError(
            "fused_group_attention: no cluster of %s blocks holds a group "
            "of M %d x (D %d + A %d) x %d B in %d shared bytes a block"
            % (cluster or CLUSTERS, m, d, a, table_bytes, SMEM_MAX))
    per_sm, c, p, dw, aw, bd, ba = min(fits)
    per_sm, p = -per_sm, -p
    run = run or min(MAX_RUN, max(1, math.ceil(
        rows / (RUNS_PER_SLOT * max(1, sms * per_sm // c)))))
    smem = _smem_bytes(m, dw, aw, bd, ba, table_bytes, run, p, c)
    if run > MAX_RUN or smem > SMEM_MAX:
        raise ValueError("fused_group_attention: %d rows per run (at most "
                         "%d) need %d shared bytes a block, over %d"
                         % (run, MAX_RUN, smem, SMEM_MAX))
    return FusedPlan(cluster=c, rows_per_run=run, runs=math.ceil(rows / run),
                     batch=p, d_slice=dw, a_slice=aw, box_d=bd, box_a=ba,
                     smem_bytes=smem, bulk=bulk)


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (
        ha, fc_sentinel, det_groups, groups_proj))
    plan = fused_launch_plan(rows, m, d, a, det_groups.element_size(),
                             aligned, _build.sm_count(dev))
    _launch(_build.library(), plan, item, ctrl, ha, sent_w, sent_mask,
            fc_sentinel, att_a_vec, det_groups, groups_proj, out, gsum)
    fused_group_attention.launches += 1
    return out, gsum


fused_group_attention.launches = 0


def _launch(lib, plan, item, ctrl, ha, sent_w, sent_mask, fc_sentinel,
            att_a_vec, det_groups, groups_proj, out, gsum):
    """Launch the kernel of library `lib` (`_build.library()`, or the
    checked build) with `plan` on tensors `fused_group_attention` has
    checked, into the caller's `out` and `gsum` (uncounted: the wrapper
    counts; tools/memcheck.py passes guarded buffers). Raises if the card
    refuses the launch."""
    b, l, m, d = det_groups.shape
    err = lib.vsrcic_fused_attention(
        item.data_ptr(), ctrl.data_ptr(), ha.data_ptr(), sent_w.data_ptr(),
        sent_mask.data_ptr(), fc_sentinel.data_ptr(), att_a_vec.data_ptr(),
        det_groups.data_ptr(), groups_proj.data_ptr(),
        int(det_groups.dtype == torch.bfloat16), ha.shape[0], b, l, m, d,
        groups_proj.shape[-1], plan.cluster, plan.rows_per_run, plan.batch,
        plan.d_slice, plan.a_slice, plan.box_d, plan.box_a, plan.smem_bytes,
        int(plan.bulk), out.data_ptr(), gsum.data_ptr(),
        torch.cuda.current_stream(ha.device).cuda_stream)
    _build.check(err, "fused_group_attention", lib)
