"""Fused vocab head: out_fc product + per-row top-k + logsumexp.

Counterpart of `vsrcic_tpu/ops/vocab_topk.py`. The joint (word x gate) beam
needs, per decode row, only the top-k word logits and the row's logsumexp
(`decode/beam.beam_search_joint_candidates`), so the (rows, V) logits never
have to reach device memory. Tie order is `jax.lax.top_k`'s: values
descending, the lowest vocab id first among equal values.

`vocab_topk_lse_plain` is the plain PyTorch version (counterpart of
`vocab_topk_lse_xla`). The wrapper `vocab_topk_lse` runs it for CPU tensors
and launches a CUDA kernel (`csrc/vocab_topk.cu`) for CUDA tensors; it
never falls back. The operands and the shape choose the route
(`vocab_launch_plan`), as `make_vocab_topk_lse`'s `lhs_dtype` and
`table_dtype` choose the TPU kernel's product:

  * f32 h2, bf16 table, V a multiple of 8 and W_t 16-byte aligned (the
    beam's shape): the split route (`launches_split` counts these). Every
    entry of a bf16 table is exact in bf16, and `split_bf16x3` writes the
    f32 h2 as three bf16 planes whose sum is h2 exactly (hi + mid + lo, 8
    significant bits each); a bf16 x bf16 product is exact in f32, so
    hi @ W + mid @ W + lo @ W on the tensor cores with f32 accumulation is
    the f32 product JAX takes (`jnp.dot(h2, W_t.astype(f32))`), up to the
    order of the f32 sums, which every kernel here takes the freedom of
    (an infinite weight meets the zeros of mid and lo: 0 x inf = NaN where
    the f32 product gives +-inf). The planes then run the bf16 route's TMA
    kernel in 128 x 128 tiles, each 64-deep stage's sums added to a
    running f32 total (`SPLIT_*`; csrc/vocab_topk.cu says why);
  * f32 h2 otherwise (f32 tables, V 30), and bf16 h2 on an f32 table (h2
    upcast exactly): the f32 product on the CUDA cores (a tiled SGEMM);
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
SPLIT_TILE_V = 128       # the split route's (csrc T_BN_SPLIT)
SMS = 132                # streaming multiprocessors of an H100 SXM (default)
SMEM_MAX = 232_448       # dynamic shared bytes one block may use
TMA_DEPTH = 64           # depth of a TMA stage (csrc T_BK): 128 bytes
TMA_STAGE_BYTES = 2 * TILE_M * TMA_DEPTH + 2 * TMA_DEPTH * TMA_TILE_V
TMA_STAGES = 4           # ring slots of the TMA route (csrc allows 2-4)
TMA_MAX_STAGES = 4       # csrc T_MAX_STAGES
TMA_CLUSTER = 2          # CTAs of a TMA-route cluster (csrc T_CLUSTER)
MMA_SYNC_SMEM = 67_584   # the mma.sync route's shared bytes (csrc BF16_SMEM)
SPLIT_PLANES = 3         # bf16 planes of a split f32 h2 (csrc T_PLANES)
# the split route's ring: three 64 KB slots, each the three planes' boxes
# beside one depth of W_t (one plane a slot, W_t copied once a plane, was
# slower; PERF.md §6)
SPLIT_STAGES = 3
_FLOATS = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class VocabPlan:
    route: str         # "split", "tma" (wgmma fed by TMA), "mma_sync" or
                       # "sgemm" (the f32 product on the CUDA cores)
    tile_m: int        # rows per tile
    tile_n: int        # vocab columns per tile: ceil(V / tile_n) partials
    stages: int        # shared-memory ring slots (mma.sync, SGEMM: two)
    cluster: int       # CTAs of a cluster, along the rows (1: none)
    grid: int          # CTAs launched (TMA: persistent, at most one an SM)
    smem_bytes: int    # dynamic shared bytes per CTA (SGEMM: static only)
    planes: int = 1    # bf16 planes of h2 (the split route's three)


def _tma_smem(stages, planes=1):
    """csrc/vocab_topk.cu's tma_smem_bytes: 1024 bytes to align the ring,
    the stages (the h2 box of each plane and one depth of the tile's W_t
    each), a full and an empty mbarrier per stage."""
    tile_n = TMA_TILE_V if planes == 1 else SPLIT_TILE_V
    stage = 2 * TMA_DEPTH * (planes * TILE_M + tile_n)
    return 1024 + stages * stage + 2 * 8 * stages


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


def _check(rows, r, v, k, aligned, sms, resident):
    if (min(rows, r, v, sms) < 1 or not 1 <= k <= min(v, K_MAX)
            or not isinstance(aligned, bool)
            or (resident is not None and resident < 1)):
        raise ValueError("vocab launch plan: rows %s, R %s, V %s, k %s, "
                         "aligned %s, SMs %s, resident clusters %s"
                         % (rows, r, v, k, aligned, sms, resident))


def _tma_plan(route, rows, v, sms, stages, resident, planes=1):
    """The TMA kernel's plan: persistent clusters, as many as the card
    holds at once and the groups of tiles need; tiles of TMA_TILE_V
    columns on one plane, SPLIT_TILE_V on the split's three."""
    if not 2 <= stages <= TMA_MAX_STAGES:
        raise ValueError("vocab launch plan: %s stages" % stages)
    c = TMA_CLUSTER
    tile_n = TMA_TILE_V if planes == 1 else SPLIT_TILE_V
    n_rb, n_vt = math.ceil(rows / TILE_M), math.ceil(v / tile_n)
    # clusters along the rows on one plane, along the vocab on three
    groups = (math.ceil(n_rb / c) * n_vt if planes == 1
              else n_rb * math.ceil(n_vt / c))
    clusters = min(resident or sms // c, sms // c, groups)
    smem = _tma_smem(stages, planes)
    if smem > SMEM_MAX:
        raise ValueError("vocab launch plan: %d stages of %d planes need "
                         "%d shared bytes" % (stages, planes, smem))
    return VocabPlan(route, TILE_M, tile_n, stages, c,
                     max(1, clusters) * c, smem, planes)


def _plan(rows, r, v, k, aligned, sms, stages=None, resident=None):
    """`vocab_bf16_launch_plan`, or with the TMA route's ring depth fixed
    (tools/ab_vocab.py's sweep)."""
    _check(rows, r, v, k, aligned, sms, resident)
    if not (r % 8 == 0 and v % 8 == 0 and aligned):
        return VocabPlan("mma_sync", TILE_M, TILE_V, 2, 1,
                         math.ceil(rows / TILE_M) * math.ceil(v / TILE_V),
                         MMA_SYNC_SMEM)
    return _tma_plan("tma", rows, v, sms, stages or TMA_STAGES, resident)


def _split_plan(rows, r, v, k, aligned, sms, stages=None, resident=None):
    """The f32-h2 plan on a bf16 table (`vocab_launch_plan`), or with the
    split route's ring depth fixed (tools/ab_vocab.py's sweep)."""
    _check(rows, r, v, k, aligned, sms, resident)
    if not (v % 8 == 0 and aligned):
        return _sgemm_plan(rows, v)
    return _tma_plan("split", rows, v, sms, stages or SPLIT_STAGES, resident,
                     SPLIT_PLANES)


def _sgemm_plan(rows, v):
    return VocabPlan("sgemm", TILE_M, TILE_V, 2, 1,
                     math.ceil(rows / TILE_M) * math.ceil(v / TILE_V), 0)


@functools.lru_cache(maxsize=256)
def vocab_launch_plan(rows, r, v, k, h2_dtype, table_dtype, aligned=True,
                      sms=SMS, resident=None):
    """The route `vocab_topk_lse` takes for h2 (rows, R) of `h2_dtype` and
    a W_t (R, V) of `table_dtype`, top k, on a card of `sms` SMs holding
    `resident` clusters of the route at once. `aligned`: the bases TMA
    reads are 16-byte aligned (h2 and W_t; on the split route only W_t,
    since the wrapper allocates the planes). bf16 h2 and table:
    `vocab_bf16_launch_plan`; f32 h2 on a bf16 table: "split" where TMA
    can describe W_t (V a multiple of 8, aligned; R any: the planes are
    padded to a multiple of 8), else "sgemm"; anything else "sgemm" (bf16
    h2 on an f32 table is upcast first). Raises ValueError on shapes no
    route takes."""
    bf16 = torch.bfloat16
    if h2_dtype not in _FLOATS or table_dtype not in _FLOATS:
        raise ValueError("vocab launch plan: dtypes %s, %s"
                         % (h2_dtype, table_dtype))
    if h2_dtype == bf16 and table_dtype == bf16:
        return vocab_bf16_launch_plan(rows, r, v, k, aligned, sms, resident)
    if table_dtype == bf16:
        return _split_plan(rows, r, v, k, aligned, sms, resident=resident)
    _check(rows, r, v, k, aligned, sms, resident)
    return _sgemm_plan(rows, v)


@functools.lru_cache(maxsize=None)
def resident_clusters(device, stages, planes=1):
    """The TMA kernel's clusters (TMA_CLUSTER CTAs with `stages` ring
    slots on `planes` h2 planes) that `device` holds at once
    (cudaOccupancyMaxActiveClusters: a GPC whose SMs do not divide by the
    cluster size leaves some idle)."""
    out = ctypes.c_int(0)
    _build.check(_build.library().vsrcic_vocab_tma_clusters(
        _tma_smem(stages, planes), planes, ctypes.byref(out)),
        "vocab_topk_lse (cluster occupancy)")
    return out.value


def tile_walk(plan, rows, v):
    """The (row block, vocab tile) pairs each CTA of `plan` computes, in
    order, as the kernel walks them. Cluster c (CTAs c * C.., C =
    plan.cluster) takes groups c, c + grid / C, ... TMA route: a group is
    C row blocks of one vocab tile, ordered by vocab tile, then row group;
    the CTA of rank m takes row block m of each. Split route: a group is C
    vocab tiles of one row block, ordered by vocab pair, then row block;
    the CTA of rank m takes vocab tile m of each. Blocks past the rows and
    tiles past V are computed and not written, so not listed. mma.sync
    route: CTA (x, y) = (vocab tile, row block) takes its own; so does the
    SGEMM's."""
    n_rb = math.ceil(rows / plan.tile_m)
    n_vt = math.ceil(v / plan.tile_n)
    if plan.route not in ("tma", "split"):
        return [[(b // n_vt, b % n_vt)] for b in range(plan.grid)]
    c = plan.cluster
    clusters = plan.grid // c
    walk = []
    for b in range(plan.grid):
        if plan.route == "tma":
            n_rbg = math.ceil(n_rb / c)
            tiles = [((p % n_rbg) * c + b % c, p // n_rbg)
                     for p in range(b // c, n_rbg * n_vt, clusters)]
        else:
            tiles = [(p % n_rb, p // n_rb * c + b % c)
                     for p in range(b // c, n_rb * math.ceil(n_vt / c),
                                    clusters)]
        walk.append([t for t in tiles if t[0] < n_rb and t[1] < n_vt])
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


def split_bf16x3_plain(h2):
    """Plain version of the split pass (csrc/vocab_topk.cu's
    vocab_split_kernel, bit for bit): f32 h2 (rows, R) -> bf16 planes (3,
    rows, R8), R8 = R rounded up to 8, columns R..R8 zero. hi is h2
    rounded toward zero (its top 16 bits), mid the same of h2 - hi, lo
    h2 - hi - mid rounded to nearest even; both differences are exact in
    f32 and lo has at most 8 significant bits, so hi + mid + lo == h2
    exactly wherever |h2| >= 2^-100 (below, lo may lose bits under
    2^-133). A non-finite entry goes whole into hi (a NaN stays a NaN, its
    sign kept), with 0 in mid and lo. Integer arithmetic on the bits, so
    it gives the same planes on every device."""
    x = h2.float()
    x = torch.nn.functional.pad(x, (0, -x.shape[1] % 8)).contiguous()
    top = -65536                                 # 0xffff0000 as an int32
    u = x.view(torch.int32)
    r1 = torch.where(torch.isfinite(x),
                     x - (u & top).view(torch.float32), 0.0)
    u1 = r1.view(torch.int32)
    u2 = (r1 - (u1 & top).view(torch.float32)).view(torch.int32)
    hi = torch.where(torch.isnan(x), (u >> 16) | 0x40, u >> 16)
    lo = (u2 + 0x7FFF + ((u2 >> 16) & 1)) >> 16
    return torch.stack([hi, u1 >> 16, lo]).to(torch.int16).view(
        torch.bfloat16)


def split_bf16x3(h2):
    """The split pass: `split_bf16x3_plain` for CPU tensors; for CUDA
    tensors (f32, contiguous) the card's `vsrcic_vocab_split`, counted in
    `split_bf16x3.launches`. Raises if the card refuses the launch."""
    if h2.device.type == "cpu":
        return split_bf16x3_plain(h2)
    if h2.device.type != "cuda":
        raise ValueError("split_bf16x3: unsupported device %s" % h2.device)
    rows, r = h2.shape
    _build.check_tensor(h2, "h2", (rows, r), torch.float32, h2.device)
    planes = torch.empty((SPLIT_PLANES, rows, r + -r % 8),
                         dtype=torch.bfloat16, device=h2.device)
    if rows == 0:
        return planes
    _build.check(_build.library().vsrcic_vocab_split(
        h2.data_ptr(), rows, r, planes.data_ptr(),
        torch.cuda.current_stream(h2.device).cuda_stream), "split_bf16x3")
    split_bf16x3.launches += 1
    return planes


split_bf16x3.launches = 0


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
    aligned = w_t.data_ptr() % 16 == 0 and (
        h2.data_ptr() % 16 == 0 or not tensor_cores)
    sms = _build.sm_count(dev)
    plan = vocab_launch_plan(rows, r, v, k, h2.dtype, w_t.dtype, aligned,
                             sms)
    if plan.route in ("tma", "split"):
        plan = vocab_launch_plan(
            rows, r, v, k, h2.dtype, w_t.dtype, aligned, sms,
            resident_clusters(dev, plan.stages, plan.planes))
    out = _launch(plan, h2, w_t, bias, k)
    vocab_topk_lse.launches += 1
    vocab_topk_lse.launches_bf16 += tensor_cores
    vocab_topk_lse.launches_bf16_tma += plan.route == "tma"
    vocab_topk_lse.launches_split += plan.route == "split"
    return out


vocab_topk_lse.launches = 0
vocab_topk_lse.launches_bf16 = 0
vocab_topk_lse.launches_bf16_tma = 0
vocab_topk_lse.launches_split = 0


def _launch(plan, h2, w_t, bias, k):
    """Launch `plan`'s route on tensors `vocab_topk_lse` has checked: the
    f32 entry point ("sgemm"), or the bf16 one on h2 ("tma", "mma_sync")
    or on the planes of `split_bf16x3(h2)` ("split"; the split pass
    counts itself, stage 1 and the merge are uncounted: the wrapper
    counts; tools/ab_vocab.py's sweep passes other plans). Raises if the
    card refuses a launch."""
    dev = h2.device
    rows, r = h2.shape
    v = w_t.shape[-1]
    f32 = torch.float32
    vals = torch.empty((rows, k), dtype=f32, device=dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    lse = torch.empty((rows, 1), dtype=f32, device=dev)
    n_tiles = math.ceil(v / plan.tile_n)
    # each vocab tile's partial top-k and (max, sum) of each row: by tile,
    # or by row on the TMA kernel (its merge reads a row's partials at once)
    by_row = plan.route in ("tma", "split")
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
    if plan.route == "sgemm":
        err = lib.vsrcic_vocab_topk(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
            int(w_t.dtype == torch.bfloat16), rows, r, v, k, *parts)
    else:
        lhs = split_bf16x3(h2) if plan.route == "split" else h2
        err = lib.vsrcic_vocab_topk_bf16(
            lhs.data_ptr(), w_t.data_ptr(), bias.data_ptr(), rows, r, v, k,
            int(plan.route != "mma_sync"), plan.tile_n, plan.planes,
            plan.stages, plan.cluster, plan.grid, plan.smem_bytes, *parts)
    _build.check(err, "vocab_topk_lse")
    return vals, ids, lse
