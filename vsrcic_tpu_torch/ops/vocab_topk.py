"""Fused vocab head: out_fc product + per-row top-k + logsumexp.

Counterpart of `vsrcic_tpu/ops/vocab_topk.py`. The joint (word x gate) beam
needs, per decode row, only the top-k word logits and the row's logsumexp
(`decode/beam.beam_search_joint_candidates`), so the (rows, V) logits never
have to reach device memory. Tie order is `jax.lax.top_k`'s: values
descending, the lowest vocab id first among equal values.

`vocab_topk_lse_plain` is the plain PyTorch version (counterpart of
`vocab_topk_lse_xla`). The wrapper `vocab_topk_lse` runs it for CPU tensors
and launches a CUDA kernel (`csrc/vocab_topk.cu`) for CUDA tensors; it
never falls back. The operands choose the kernel, as `make_vocab_topk_lse`'s
`lhs_dtype` and `table_dtype` choose the TPU kernel's product:

  * f32 h2, f32 or bf16 table: the f32 product on the CUDA cores;
  * bf16 h2, f32 table: h2 upcast (exactly), then the same f32 kernel;
  * bf16 h2, bf16 table: the bf16 product on the tensor cores with f32
    accumulation (`launches_bf16` counts these too), by the route that
    `vocab_bf16_launch_plan` picks: wgmma fed by TMA where TMA can describe
    the operands (`launches_bf16_tma` counts these), else mma.sync.

Non-finite logits rank as `jax.lax.top_k` ranks them (XLA's total order:
NaN above +inf, +0 above -0) and the logsumexp is `jax.nn.logsumexp`'s
(NaN if any logit is NaN, else +inf if any is +inf; -inf on an all -inf
row), in the plain version and in both kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from vsrcic_tpu_torch.core.nn import top_k
from vsrcic_tpu_torch.ops import _build

# the kernel keeps this many candidates per thread; k must not exceed it
K_MAX = 16
# rows and vocab columns per tile of the kernels' first stage
# (csrc/vocab_topk.cu: TR, TV; the TMA route's T_BM, T_BN)
TILE_M = 128
TILE_V = 128
TMA_TILE_V = 256
SMS = 132                # streaming multiprocessors of an H100 SXM (default)
SMEM_MAX = 232_448       # dynamic shared bytes one block may use
TMA_DEPTH = 64           # depth of a TMA stage (csrc T_BK): 128 bytes
TMA_STAGE_BYTES = 2 * TILE_M * TMA_DEPTH + 2 * TMA_DEPTH * TMA_TILE_V
TMA_STAGES = 4           # ring slots of the TMA route (csrc allows 2-4)
TMA_CLUSTER = 2          # CTAs of a TMA-route cluster (csrc T_CLUSTER)
MMA_SYNC_SMEM = 67_584   # the mma.sync route's shared bytes (csrc BF16_SMEM)
_FLOATS = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class VocabPlan:
    route: str         # "tma" (wgmma fed by TMA) or "mma_sync"
    tile_m: int        # rows per tile
    tile_n: int        # vocab columns per tile: ceil(V / tile_n) partials
    stages: int        # shared-memory ring slots (mma.sync: its two)
    cluster: int       # CTAs of a cluster, along the rows (1: none)
    grid: int          # CTAs launched (TMA: persistent, at most one an SM)
    smem_bytes: int    # dynamic shared bytes per CTA


def _tma_smem(stages):
    """csrc/vocab_topk.cu's tma_smem_bytes: 1024 bytes to align the ring,
    the stages, a full and an empty mbarrier per stage."""
    return 1024 + stages * TMA_STAGE_BYTES + 2 * 8 * stages


@functools.lru_cache(maxsize=256)
def vocab_bf16_launch_plan(rows, r, v, k, aligned=True, sms=SMS,
                           resident=None):
    """The bf16-operand kernel's launch for (rows, R) x (R, V), top k, on a
    card of `sms` SMs that holds `resident` of the TMA route's clusters at
    once (`resident_clusters`; default sms // TMA_CLUSTER). TMA's tensor
    maps need 16-byte row strides and bases: where R and V are multiples
    of 8 and h2 and W_t are `aligned` to 16 bytes, the route is "tma":
    persistent CTAs, one an SM at most, in clusters of TMA_CLUSTER along
    the rows that multicast the W_t boxes they share, as many clusters as
    are resident at once (a second wave would double the time), walking
    128 x 256 tiles with TMA_STAGES ring slots; otherwise "mma_sync" (one
    CTA a 128 x 128 tile). Raises ValueError on shapes no route takes."""
    return _plan(rows, r, v, k, aligned, sms, resident=resident)


def _plan(rows, r, v, k, aligned, sms, stages=None, resident=None):
    """`vocab_bf16_launch_plan`, or with the TMA route's ring depth fixed
    (tools/ab_vocab.py's sweep)."""
    if (min(rows, r, v, sms) < 1 or not 1 <= k <= min(v, K_MAX)
            or not isinstance(aligned, bool)
            or (resident is not None and resident < 1)):
        raise ValueError("vocab_bf16_launch_plan: rows %s, R %s, V %s, k %s, "
                         "aligned %s, SMs %s, resident clusters %s"
                         % (rows, r, v, k, aligned, sms, resident))
    n_rb = math.ceil(rows / TILE_M)
    if not (r % 8 == 0 and v % 8 == 0 and aligned):
        return VocabPlan("mma_sync", TILE_M, TILE_V, 2, 1,
                         n_rb * math.ceil(v / TILE_V), MMA_SYNC_SMEM)
    c = TMA_CLUSTER
    stages = stages or TMA_STAGES
    if not 2 <= stages <= 4:
        raise ValueError("vocab_bf16_launch_plan: %s stages" % stages)
    groups = math.ceil(n_rb / c) * math.ceil(v / TMA_TILE_V)
    clusters = min(resident or sms // c, sms // c, groups)
    smem = _tma_smem(stages)
    assert smem <= SMEM_MAX
    return VocabPlan("tma", TILE_M, TMA_TILE_V, stages, c,
                     max(1, clusters) * c, smem)


@functools.lru_cache(maxsize=None)
def resident_clusters(device, stages):
    """The TMA route's clusters (TMA_CLUSTER CTAs with `stages` ring slots)
    that `device` holds at once (cudaOccupancyMaxActiveClusters: a GPC
    whose SMs do not divide by the cluster size leaves some idle)."""
    out = ctypes.c_int(0)
    _build.check(_build.library().vsrcic_vocab_tma_clusters(
        _tma_smem(stages), ctypes.byref(out)),
        "vocab_topk_lse (cluster occupancy)")
    return out.value


def tile_walk(plan, rows, v):
    """The (row block, vocab tile) pairs each CTA of `plan` computes, in
    order, as the kernel walks them. TMA route: cluster c (CTAs c * C..,
    C = plan.cluster) takes groups c, c + grid / C, ... of C row blocks of
    one vocab tile, ordered by vocab tile, then row group; its CTA of rank
    m takes row block m of each (blocks past the rows are computed and not
    written, so not listed). mma.sync route: CTA (x, y) = (vocab tile, row
    block) takes its own."""
    n_rb = math.ceil(rows / plan.tile_m)
    n_vt = math.ceil(v / plan.tile_n)
    if plan.route != "tma":
        return [[(b // n_vt, b % n_vt)] for b in range(plan.grid)]
    c = plan.cluster
    n_rbg = math.ceil(n_rb / c)
    clusters = plan.grid // c
    walk = []
    for b in range(plan.grid):
        tiles = [((p % n_rbg) * c + b % c, p // n_rbg)
                 for p in range(b // c, n_rbg * n_vt, clusters)]
        walk.append([t for t in tiles if t[0] < n_rb])
    return walk


def vocab_topk_lse_plain(h2, w_t, bias, k: int):
    """Plain version: materialises the logits in f32.

    h2: (rows, R) f32 or bf16; w_t: (R, V) bf16 or f32; bias: (V,). Both
    operands are upcast (exactly) and multiplied in f32; a bf16 x bf16
    product is exact in f32, so this is also the bf16-operand kernel's
    function. -> (vals (rows, k) f32, ids (rows, k) int32, lse (rows, 1)
    f32)."""
    logits = h2.float() @ w_t.float() + bias.float()
    vals, ids = top_k(logits, k)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, ids.to(torch.int32), lse


def vocab_topk_lse(h2, w_t, bias, k: int):
    """Plain version for CPU tensors; a CUDA kernel for CUDA tensors (see
    the module's note). Any rows, R and V; 1 <= k <= min(V, K_MAX); h2 and
    w_t float32 or bfloat16, bias float32 on the card."""
    if h2.dtype not in _FLOATS or w_t.dtype not in _FLOATS:
        raise ValueError("vocab_topk_lse: h2 and w_t must be float32 or "
                         "bfloat16, got %s and %s" % (h2.dtype, w_t.dtype))
    if h2.device.type == "cpu":
        return vocab_topk_lse_plain(h2, w_t, bias, k)
    if h2.device.type != "cuda":
        raise ValueError("vocab_topk_lse: unsupported device %s" % h2.device)
    bf16 = torch.bfloat16
    tensor_cores = h2.dtype == bf16 and w_t.dtype == bf16
    if h2.dtype == bf16 and not tensor_cores:
        h2 = h2.float()   # bf16 h2 x f32 table: an f32 product, as in JAX
    dev = h2.device
    rows, r = h2.shape
    v = w_t.shape[-1]
    if not 1 <= k <= min(v, K_MAX):
        raise ValueError("vocab_topk_lse: k=%d outside [1, min(V=%d, %d)]"
                         % (k, v, K_MAX))
    f32 = torch.float32
    for t, name, shape, dtype in ((h2, "h2", (rows, r), h2.dtype),
                                  (w_t, "w_t", (r, v), w_t.dtype),
                                  (bias, "bias", (v,), f32)):
        _build.check_tensor(t, name, shape, dtype, dev)
    if rows == 0:
        return (torch.empty((0, k), dtype=f32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, 1), dtype=f32, device=dev))
    plan = None
    if tensor_cores:
        aligned = h2.data_ptr() % 16 == 0 and w_t.data_ptr() % 16 == 0
        plan = vocab_bf16_launch_plan(
            rows, r, v, k, aligned, _build.sm_count(dev),
            resident_clusters(dev, TMA_STAGES))
    out = _launch(plan, h2, w_t, bias, k)
    vocab_topk_lse.launches += 1
    if plan:
        vocab_topk_lse.launches_bf16 += 1
        if plan.route == "tma":
            vocab_topk_lse.launches_bf16_tma += 1
    return out


vocab_topk_lse.launches = 0
vocab_topk_lse.launches_bf16 = 0
vocab_topk_lse.launches_bf16_tma = 0


def _launch(plan, h2, w_t, bias, k):
    """Launch the f32 entry point (`plan` None) or the bf16 one with `plan`
    on tensors `vocab_topk_lse` has checked (uncounted: the wrapper counts;
    tools/ab_vocab.py's sweep passes other plans). Raises if the card
    refuses the launch."""
    dev = h2.device
    rows, r = h2.shape
    v = w_t.shape[-1]
    f32 = torch.float32
    vals = torch.empty((rows, k), dtype=f32, device=dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    lse = torch.empty((rows, 1), dtype=f32, device=dev)
    n_tiles = math.ceil(v / (plan.tile_n if plan else TILE_V))
    # each vocab tile's partial top-k and (max, sum) of each row: by tile,
    # or by row on the TMA route (its merge reads a row's partials at once)
    by_row = plan is not None and plan.route == "tma"
    lead = (rows, n_tiles) if by_row else (n_tiles, rows)
    part_vals = torch.empty(lead + (k,), dtype=f32, device=dev)
    part_ids = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    part_m = torch.empty(lead, dtype=f32, device=dev)
    part_s = torch.empty(lead, dtype=f32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = (part_vals.data_ptr(), part_ids.data_ptr(), part_m.data_ptr(),
             part_s.data_ptr(), vals.data_ptr(), ids.data_ptr(),
             lse.data_ptr(), stream)
    if plan:
        err = lib.vsrcic_vocab_topk_bf16(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(), rows, r, v, k,
            int(plan.route == "tma"), plan.tile_n, plan.stages, plan.cluster,
            plan.grid, plan.smem_bytes, *parts)
    else:
        err = lib.vsrcic_vocab_topk(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
            int(w_t.dtype == torch.bfloat16), rows, r, v, k, *parts)
    _build.check(err, "vocab_topk_lse")
    return vals, ids, lse
