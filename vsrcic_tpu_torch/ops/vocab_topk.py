"""Fused vocab head: out_fc product + per-row top-k + logsumexp.

Counterpart of `vsrcic_tpu/ops/vocab_topk.py`. The joint (word x gate) beam
needs, per decode row, only the top-k word logits and the row's logsumexp
(`decode/beam.beam_search_joint_candidates`), so the (rows, V) logits never
have to reach device memory. Tie order is `jax.lax.top_k`'s: values
descending, the lowest vocab id first among equal values.

`vocab_topk_lse_plain` is the plain PyTorch version (counterpart of
`vocab_topk_lse_xla`). The wrapper `vocab_topk_lse` runs it for CPU tensors
and launches a CUDA kernel (`csrc/vocab_topk.cu`) for CUDA tensors; it
never falls back. The operands' types and layout choose the route
(`vocab_launch_plan`), as `make_vocab_topk_lse`'s `lhs_dtype` and
`table_dtype` choose the TPU kernel's product. W_t (R, V) may be a view
whose rows lie `ldw` >= V apart: `padded_table` stores a table at a pitch
of V rounded up to 8, as the captioner facade does once per captioner
(JAX's `prepare_tables` pads once too).

Where TMA can describe W_t (rows a multiple of 8 apart, base 16-byte
aligned), every operand is taken as bf16 planes on the tensor cores: a
bf16 tensor is one plane, and `split_bf16x3` writes an f32 one as three
(hi + mid + lo, 8 significant bits each) whose sum is it exactly. A bf16 x
bf16 product is exact in f32, so the planes' products summed in f32 are the
f32 product JAX takes (`jnp.dot(h2, W_t.astype(f32))`), up to the order of
the f32 sums, which every kernel here takes the freedom of; an infinite
entry meets the other operand's zero planes, 0 x inf = NaN where the f32
product gives +-inf (`vocab_planes_plain` replays the planes' function).
An infinite weight meets them wherever h2 is split ("split", "split9"), so
a caller that knows its W_t holds a non-finite entry passes
`finite_table=False`, and those routes become "sgemm" below, which gives
the f32 product's +-inf and NaN. The captioner facade checks its table once
when it builds it and passes the flag; the op cannot check W_t on every
call without a read-back, so a caller that passes its own non-finite table
without the flag gets the planes' NaN. "split_w" and "tma" keep h2 as one
plane and meet a zero plane only where h2 is 0, where the f32 product
gives NaN too.
Each 64-deep stage's products are summed on the TMA kernel (128 x 128
tiles) and added to a running f32 total (csrc/vocab_topk.cu says why):

  * f32 h2, bf16 table: "split", h2's three planes (`launches_split`);
  * f32 h2, f32 table: "split9", three times W_t's three
    (`launches_split9`);
  * bf16 h2, f32 table: "split_w", W_t's three (`launches_split_w`; an h2
    TMA cannot describe is upcast, exactly, and takes "split9");
  * bf16 h2, bf16 table: "tma", wgmma fed by TMA on 128 x 256 tiles
    (`launches_bf16_tma`; `vocab_bf16_launch_plan`), or "mma_sync" where
    TMA cannot describe h2 or W_t; both count in `launches_bf16`.

W_t's planes are made once per table: pass them as `w_planes`
(`table_planes`), or the wrapper splits W_t on every call. A W_t that TMA
cannot describe (an unaligned base, or rows not a multiple of 8 apart;
only callers that pass their own tables) takes the f32 product on the
CUDA cores, "sgemm" (`launches_sgemm`; a bf16 h2 upcast first), as does
a non-finite table on the routes that split h2.

Non-finite logits rank as `jax.lax.top_k` ranks them (XLA's total order:
NaN above +inf, +0 above -0) and the logsumexp is `jax.nn.logsumexp`'s
(NaN if any logit is NaN, else +inf if any is +inf; -inf on an all -inf
row), in the plain version and in every kernel.
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
# (csrc/vocab_topk.cu: TR, TV; the TMA routes' T_BM, T_BN)
TILE_M = 128
TILE_V = 128
TMA_TILE_V = 256
SPLIT_TILE_V = 128       # the split routes' (csrc T_BN_SPLIT)
SMS = 132                # streaming multiprocessors of an H100 SXM (default)
SMEM_MAX = 232_448       # dynamic shared bytes one block may use
TMA_DEPTH = 64           # depth of a TMA stage (csrc T_BK): 128 bytes
TMA_STAGE_BYTES = 2 * TILE_M * TMA_DEPTH + 2 * TMA_DEPTH * TMA_TILE_V
TMA_STAGES = 4           # ring slots of the "tma" route (csrc allows 2-4)
TMA_MAX_STAGES = 4       # csrc T_MAX_STAGES
TMA_CLUSTER = 2          # CTAs of a TMA-route cluster (csrc T_CLUSTER)
MMA_SYNC_SMEM = 67_584   # the mma.sync route's shared bytes (csrc BF16_SMEM)
SPLIT_PLANES = 3         # bf16 planes of a split f32 tensor (csrc T_PLANES)
# the split routes' rings: three 64 KB slots, each every plane's boxes of
# both operands for one depth (one plane a slot, W_t copied once a plane,
# was slower; PERF.md §6); "split9"'s slots hold six boxes, 96 KB: two fit
SPLIT_STAGES = 3
SPLIT9_STAGES = 2
_FLOATS = (torch.float32, torch.bfloat16)
# the TMA routes: name -> (planes of h2, planes of W_t)
PLANES = {"tma": (1, 1), "split": (SPLIT_PLANES, 1),
          "split9": (SPLIT_PLANES, SPLIT_PLANES), "split_w": (1, SPLIT_PLANES)}


@dataclasses.dataclass(frozen=True)
class VocabPlan:
    route: str         # a TMA route of PLANES, "mma_sync" or "sgemm" (the
                       # f32 product on the CUDA cores)
    tile_m: int        # rows per tile
    tile_n: int        # vocab columns per tile: ceil(V / tile_n) partials
    stages: int        # shared-memory ring slots (mma.sync, SGEMM: two)
    cluster: int       # CTAs of a cluster (1: none)
    grid: int          # CTAs launched (TMA: persistent, at most one an SM)
    smem_bytes: int    # dynamic shared bytes per CTA (SGEMM: static only)
    planes: int = 1    # bf16 planes of h2 (1 or SPLIT_PLANES)
    w_planes: int = 1  # bf16 planes of W_t (1 or SPLIT_PLANES)


def _tma_smem(stages, planes=1, w_planes=1):
    """csrc/vocab_topk.cu's tma_smem_bytes: 1024 bytes to align the ring,
    the stages (the h2 box of each plane and one depth of the tile's W_t
    on each of its planes), a full and an empty mbarrier per stage."""
    tile_n = TMA_TILE_V if planes * w_planes == 1 else SPLIT_TILE_V
    stage = 2 * TMA_DEPTH * (planes * TILE_M + w_planes * tile_n)
    return 1024 + stages * stage + 2 * 8 * stages


@functools.lru_cache(maxsize=256)
def vocab_bf16_launch_plan(rows, r, v, k, aligned=True, sms=SMS,
                           resident=None, ldw=None):
    """The bf16-operand kernel's launch for (rows, R) x (R, V), top k, on a
    card of `sms` SMs that holds `resident` of the TMA route's clusters at
    once (`resident_clusters`; default sms // TMA_CLUSTER), W_t's rows
    `ldw` apart (default V). TMA's tensor maps need 16-byte row strides and
    bases: where R and ldw are multiples of 8 and h2 and W_t are `aligned`
    to 16 bytes, the route is "tma": persistent CTAs, one an SM at most,
    in clusters of TMA_CLUSTER along the rows that multicast the W_t boxes
    they share, as many clusters as are resident at once (a second wave
    would double the time), walking 128 x 256 tiles with TMA_STAGES ring
    slots; otherwise "mma_sync" (one CTA a 128 x 128 tile). Raises
    ValueError on shapes no route takes."""
    return _plan(rows, r, v, k, aligned, sms, resident=resident, ldw=ldw)


def _check(rows, r, v, k, aligned, sms, resident, ldw=None):
    if (min(rows, r, v, sms) < 1 or not 1 <= k <= min(v, K_MAX)
            or not isinstance(aligned, bool)
            or (resident is not None and resident < 1)
            or (ldw is not None and ldw < v)):
        raise ValueError("vocab launch plan: rows %s, R %s, V %s, k %s, "
                         "aligned %s, SMs %s, resident clusters %s, W_t "
                         "rows %s apart" % (rows, r, v, k, aligned, sms,
                                            resident, ldw))
    return v if ldw is None else ldw


def _tma_plan(route, rows, v, sms, stages, resident, planes=1, w_planes=1):
    """The TMA kernel's plan on `planes` of h2 and `w_planes` of W_t:
    persistent clusters, as many as the card holds at once (`resident`,
    for clusters of TMA_CLUSTER) and the groups of tiles need; tiles of
    TMA_TILE_V columns on one plane of each, else SPLIT_TILE_V. Clusters
    run along the rows on one plane of h2, along the vocab on three, where
    a vocab of one tile takes clusters of one CTA."""
    if not 2 <= stages <= TMA_MAX_STAGES:
        raise ValueError("vocab launch plan: %s stages" % stages)
    tile_n = TMA_TILE_V if planes * w_planes == 1 else SPLIT_TILE_V
    n_rb, n_vt = math.ceil(rows / TILE_M), math.ceil(v / tile_n)
    along_v = planes > 1
    c = 1 if along_v and n_vt == 1 else TMA_CLUSTER
    groups = (n_rb * math.ceil(n_vt / c) if along_v
              else math.ceil(n_rb / c) * n_vt)
    held = sms // c if c == 1 or resident is None else min(resident, sms // c)
    smem = _tma_smem(stages, planes, w_planes)
    if smem > SMEM_MAX:
        raise ValueError("vocab launch plan: %d stages of %d x %d planes "
                         "need %d shared bytes" % (stages, planes, w_planes,
                                                   smem))
    return VocabPlan(route, TILE_M, tile_n, stages, c,
                     max(1, min(held, groups)) * c, smem, planes, w_planes)


def _plan(rows, r, v, k, aligned, sms, stages=None, resident=None, ldw=None):
    """`vocab_bf16_launch_plan`, or with the TMA route's ring depth fixed
    (tools/ab_vocab.py's sweep)."""
    ldw = _check(rows, r, v, k, aligned, sms, resident, ldw)
    if not (r % 8 == 0 and ldw % 8 == 0 and aligned):
        return VocabPlan("mma_sync", TILE_M, TILE_V, 2, 1,
                         math.ceil(rows / TILE_M) * math.ceil(v / TILE_V),
                         MMA_SYNC_SMEM)
    return _tma_plan("tma", rows, v, sms, stages or TMA_STAGES, resident)


def _split_plan(rows, r, v, k, aligned, sms, stages=None, resident=None,
                ldw=None, route="split"):
    """The plan of a split route (`vocab_launch_plan`) where TMA can
    describe W_t (`aligned`, rows `ldw` apart, a multiple of 8), else
    "sgemm"; with the ring depth fixed by tools/ab_vocab.py's sweep."""
    ldw = _check(rows, r, v, k, aligned, sms, resident, ldw)
    if not (ldw % 8 == 0 and aligned):
        return _sgemm_plan(rows, v)
    planes, w_planes = PLANES[route]
    return _tma_plan(route, rows, v, sms, stages or (
        SPLIT9_STAGES if route == "split9" else SPLIT_STAGES), resident,
        planes, w_planes)


def _sgemm_plan(rows, v):
    return VocabPlan("sgemm", TILE_M, TILE_V, 2, 1,
                     math.ceil(rows / TILE_M) * math.ceil(v / TILE_V), 0)


@functools.lru_cache(maxsize=256)
def vocab_launch_plan(rows, r, v, k, h2_dtype, table_dtype, aligned=True,
                      sms=SMS, resident=None, ldw=None, finite_table=True):
    """The route `vocab_topk_lse` takes for h2 (rows, R) of `h2_dtype` and
    a W_t (R, V) of `table_dtype` whose rows lie `ldw` apart (default V),
    top k, on a card of `sms` SMs holding `resident` clusters of the route
    at once. `aligned`: the bases TMA reads are 16-byte aligned (W_t; h2
    too where it is bf16; the wrapper allocates the planes). bf16 h2 and
    table: `vocab_bf16_launch_plan`; otherwise the split route of the
    operands' types where TMA can describe W_t (ldw a multiple of 8,
    aligned; R any: h2's planes are padded to a multiple of 8, and a bf16
    h2 on an f32 table whose R is not a multiple of 8 is upcast and takes
    "split9"), else "sgemm". `finite_table=False` (W_t holds a non-finite
    entry) turns the routes that split h2, "split" and "split9", into
    "sgemm" (the module's note says why). Raises ValueError on shapes no
    route takes."""
    bf16 = torch.bfloat16
    if h2_dtype not in _FLOATS or table_dtype not in _FLOATS:
        raise ValueError("vocab launch plan: dtypes %s, %s"
                         % (h2_dtype, table_dtype))
    if h2_dtype == bf16 and table_dtype == bf16:
        return vocab_bf16_launch_plan(rows, r, v, k, aligned, sms, resident,
                                      ldw)
    if table_dtype == bf16:
        route = "split"
    else:
        route = "split_w" if h2_dtype == bf16 and r % 8 == 0 else "split9"
    if not finite_table and route != "split_w":
        _check(rows, r, v, k, aligned, sms, resident, ldw)
        return _sgemm_plan(rows, v)
    return _split_plan(rows, r, v, k, aligned, sms, resident=resident,
                       ldw=ldw, route=route)


@functools.lru_cache(maxsize=None)
def resident_clusters(device, stages, planes=1, w_planes=1):
    """The TMA kernel's clusters (TMA_CLUSTER CTAs with `stages` ring
    slots on `planes` h2 planes and `w_planes` W_t planes) that `device`
    holds at once (cudaOccupancyMaxActiveClusters: a GPC whose SMs do not
    divide by the cluster size leaves some idle)."""
    out = ctypes.c_int(0)
    _build.check(_build.library().vsrcic_vocab_tma_clusters(
        _tma_smem(stages, planes, w_planes), planes, w_planes,
        ctypes.byref(out)), "vocab_topk_lse (cluster occupancy)")
    return out.value


def tile_walk(plan, rows, v):
    """The (row block, vocab tile) pairs each CTA of `plan` computes, in
    order, as the kernel walks them. Cluster c (CTAs c * C.., C =
    plan.cluster) takes groups c, c + grid / C, ... One plane of h2 ("tma",
    "split_w"): a group is C row blocks of one vocab tile, ordered by vocab
    tile, then row group; the CTA of rank m takes row block m of each.
    Three ("split", "split9"): a group is C vocab tiles of one row block,
    ordered by vocab group, then row block; the CTA of rank m takes vocab
    tile m of each. Blocks past the rows and tiles past V are computed and
    not written, so not listed. mma.sync route: CTA (x, y) = (vocab tile,
    row block) takes its own; so does the SGEMM's."""
    n_rb = math.ceil(rows / plan.tile_m)
    n_vt = math.ceil(v / plan.tile_n)
    if plan.route not in PLANES:
        return [[(b // n_vt, b % n_vt)] for b in range(plan.grid)]
    c = plan.cluster
    clusters = plan.grid // c
    walk = []
    for b in range(plan.grid):
        if plan.planes == 1:
            n_rbg = math.ceil(n_rb / c)
            tiles = [((p % n_rbg) * c + b % c, p // n_rbg)
                     for p in range(b // c, n_rbg * n_vt, clusters)]
        else:
            tiles = [(p % n_rb, p // n_rb * c + b % c)
                     for p in range(b // c, n_rb * math.ceil(n_vt / c),
                                    clusters)]
        walk.append([t for t in tiles if t[0] < n_rb and t[1] < n_vt])
    return walk


def vocab_topk_lse_plain(h2, w_t, bias, k: int, w_planes=None,
                         finite_table=True):
    """Plain version: materialises the logits in f32.

    h2: (rows, R) f32 or bf16; w_t: (R, V) bf16 or f32; bias: (V,). Both
    operands are upcast (exactly) and multiplied in f32; a bf16 x bf16
    product is exact in f32, so this is also the bf16-operand kernel's
    function. `w_planes` and `finite_table` are the wrapper's and are not
    read: the plain version reads the f32 w_t, and is the f32 product on
    any table. -> (vals (rows, k) f32, ids (rows, k) int32, lse (rows, 1)
    f32)."""
    logits = h2.float() @ w_t.float() + bias.float()
    return _topk_lse(logits, k)


def _topk_lse(logits, k):
    vals, ids = top_k(logits, k)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, ids.to(torch.int32), lse


def vocab_planes_plain(h2, w_t, bias, k: int):
    """The TMA routes' function replayed in f32: each operand as its bf16
    planes (one for bf16, `split_bf16x3`'s three for f32), every (h2 plane,
    W_t plane) product taken over the whole depth in f32 and the products
    summed the lightest first (the kernel's order within a stage), plus the
    bias. On finite operands it is the f32 product within the f32 sums'
    order; where an infinite entry meets a zero plane of the other operand
    it gives the kernel's NaN (0 x inf), where `vocab_topk_lse_plain`
    gives +-inf. -> as vocab_topk_lse_plain."""
    def planes(x):
        if x.dtype == torch.bfloat16:
            return x.float()[None]
        return split_bf16x3_plain(x).float()[..., :x.shape[-1]]

    hp, wp = planes(h2), planes(w_t.T).transpose(1, 2)
    logits = None
    for s in range(len(hp) + len(wp) - 2, -1, -1):
        for i in range(len(hp) - 1, -1, -1):
            if 0 <= s - i < len(wp):
                prod = hp[i] @ wp[s - i]
                logits = prod if logits is None else logits + prod
    return _topk_lse(logits + bias.float(), k)


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
    _split_launch(_build.library(), h2, planes)
    split_bf16x3.launches += 1
    return planes


split_bf16x3.launches = 0


def _split_launch(lib, h2, planes):
    """Launch the split pass of library `lib` (`_build.library()`, or the
    checked build) on a checked f32 h2 (rows >= 1, R) into the caller's
    `planes` (3, rows, R8), 16-byte aligned (uncounted: `split_bf16x3`
    counts; tools/memcheck.py passes guarded planes). Raises if the card
    refuses the launch."""
    rows, r = h2.shape
    _build.check(lib.vsrcic_vocab_split(
        h2.data_ptr(), rows, r, planes.data_ptr(),
        torch.cuda.current_stream(h2.device).cuda_stream), "split_bf16x3",
        lib)


def padded_table(w_t, dtype=None):
    """W_t (R, V) as `dtype` (default its own) in a zero-filled buffer of
    R rows of V8 = V rounded up to 8 entries: the [:, :V] view, rows V8
    apart from a 16-byte-aligned base, as TMA reads them."""
    r, v = w_t.shape
    buf = torch.zeros((r, v + -v % 8), dtype=dtype or w_t.dtype,
                      device=w_t.device)
    buf[:, :v] = w_t
    return buf[:, :v]


def table_planes(w_t):
    """An f32 W_t's three bf16 planes for `vocab_topk_lse(..., w_planes=)`:
    `split_bf16x3` of its rows, (3, R, V8), columns V.. zero."""
    return split_bf16x3(w_t if w_t.is_contiguous() else w_t.contiguous())


def _check_table(w_t, shape, device):
    """Raise ValueError unless w_t is a tensor of `shape` on `device`
    whose rows are contiguous (row stride >= V; a padded view)."""
    r, v = shape
    if (w_t.device != device or tuple(w_t.shape) != (r, v)
            or (v > 1 and w_t.stride(1) != 1)
            or (r > 1 and w_t.stride(0) < v)):
        raise ValueError(
            "w_t is %s %s strides %s; the kernel needs %s (%d, %d) with "
            "contiguous rows" % (w_t.device, tuple(w_t.shape),
                                 tuple(w_t.stride()), device, r, v))


def vocab_topk_lse(h2, w_t, bias, k: int, w_planes=None, finite_table=True):
    """Plain version for CPU tensors; a CUDA kernel for CUDA tensors (see
    the module's note). Any rows, R and V; 1 <= k <= min(V, K_MAX); h2 and
    w_t float32 or bfloat16, w_t's rows contiguous, bias float32 on the
    card. `w_planes`: an f32 w_t's `table_planes`, made once, where the
    caller keeps them (else made on each call that needs them).
    `finite_table`: False where the caller knows w_t holds a non-finite
    entry (`vocab_launch_plan`); not checked here."""
    if h2.dtype not in _FLOATS or w_t.dtype not in _FLOATS:
        raise ValueError("vocab_topk_lse: h2 and w_t must be float32 or "
                         "bfloat16, got %s and %s" % (h2.dtype, w_t.dtype))
    if h2.device.type == "cpu":
        return vocab_topk_lse_plain(h2, w_t, bias, k)
    if h2.device.type != "cuda":
        raise ValueError("vocab_topk_lse: unsupported device %s" % h2.device)
    bf16, f32 = torch.bfloat16, torch.float32
    dev = h2.device
    rows, r = h2.shape
    v = w_t.shape[-1]
    if not 1 <= k <= min(v, K_MAX):
        raise ValueError("vocab_topk_lse: k=%d outside [1, min(V=%d, %d)]"
                         % (k, v, K_MAX))
    for t, name, shape, dtype in ((h2, "h2", (rows, r), h2.dtype),
                                  (bias, "bias", (v,), f32)):
        _build.check_tensor(t, name, shape, dtype, dev)
    _check_table(w_t, (r, v), dev)
    if rows == 0:
        return (torch.empty((0, k), dtype=f32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, 1), dtype=f32, device=dev))
    ldw = w_t.stride(0) if r > 1 else v + -v % 8
    if h2.dtype == bf16 and w_t.dtype == f32 and h2.data_ptr() % 16:
        h2 = h2.float()   # exact: TMA cannot read it, its planes it can
    aligned = w_t.data_ptr() % 16 == 0 and (
        h2.dtype == f32 or h2.data_ptr() % 16 == 0)
    sms = _build.sm_count(dev)
    plan = vocab_launch_plan(rows, r, v, k, h2.dtype, w_t.dtype, aligned,
                             sms, ldw=ldw, finite_table=finite_table)
    if plan.route in PLANES and plan.cluster > 1:
        plan = vocab_launch_plan(
            rows, r, v, k, h2.dtype, w_t.dtype, aligned, sms,
            resident_clusters(dev, plan.stages, plan.planes, plan.w_planes),
            ldw, finite_table)
    if h2.dtype == bf16 and plan.route in ("sgemm", "split9"):
        h2 = h2.float()   # bf16 h2 x f32 table: exact, as JAX upcasts it
    if plan.w_planes > 1:
        if w_planes is None:
            w_planes = table_planes(w_t)
        _build.check_tensor(w_planes, "w_planes",
                            (SPLIT_PLANES, r, v + -v % 8), bf16, dev)
    out = _run(plan, h2, w_t, bias, k, w_planes)
    vocab_topk_lse.launches += 1
    vocab_topk_lse.launches_bf16 += plan.route in ("tma", "mma_sync")
    vocab_topk_lse.launches_bf16_tma += plan.route == "tma"
    vocab_topk_lse.launches_split += plan.route == "split"
    vocab_topk_lse.launches_split9 += plan.route == "split9"
    vocab_topk_lse.launches_split_w += plan.route == "split_w"
    vocab_topk_lse.launches_sgemm += plan.route == "sgemm"
    return out


vocab_topk_lse.launches = 0
vocab_topk_lse.launches_bf16 = 0
vocab_topk_lse.launches_bf16_tma = 0
vocab_topk_lse.launches_split = 0
vocab_topk_lse.launches_split9 = 0
vocab_topk_lse.launches_split_w = 0
vocab_topk_lse.launches_sgemm = 0


def vocab_buffers(plan, rows, v, k, device, empty=torch.empty):
    """The buffers `_launch` writes for `plan` on (rows, V), top k, made by
    `empty(shape, dtype=, device=)` (tools/memcheck.py passes guarded
    ones): ((vals (rows, k) f32, ids (rows, k) int32, lse (rows, 1) f32),
    (the partials of stage 1: part_vals, part_ids (lead, k), part_m,
    part_s (lead))): each vocab tile's partial top-k and (max, sum) of each
    row, by tile, lead (ceil(V / plan.tile_n), rows), or by row on the TMA
    kernel, lead (rows, tiles): its merge reads a row's partials at
    once."""
    f32, i32 = torch.float32, torch.int32
    outs = (empty((rows, k), dtype=f32, device=device),
            empty((rows, k), dtype=i32, device=device),
            empty((rows, 1), dtype=f32, device=device))
    n_tiles = math.ceil(v / plan.tile_n)
    lead = (rows, n_tiles) if plan.route in PLANES else (n_tiles, rows)
    parts = (empty(lead + (k,), dtype=f32, device=device),
             empty(lead + (k,), dtype=i32, device=device),
             empty(lead, dtype=f32, device=device),
             empty(lead, dtype=f32, device=device))
    return outs, parts


def _run(plan, h2, w_t, bias, k, w_planes=None):
    """`plan`'s route on the default library, on tensors `vocab_topk_lse`
    has checked (or tools/ab_vocab.py's sweep's plans): its buffers
    allocated, h2 split first where the plan takes its planes
    (`split_bf16x3`, which counts itself); -> (vals, ids, lse). Stage 1 and
    the merge are uncounted: the wrapper counts."""
    rows = h2.shape[0]
    h2_planes = split_bf16x3(h2) if plan.planes > 1 else None
    outs, parts = vocab_buffers(plan, rows, w_t.shape[-1], k, h2.device)
    _launch(_build.library(), plan, h2, w_t, bias, k, w_planes, h2_planes,
            parts, outs)
    return outs


def _launch(lib, plan, h2, w_t, bias, k, w_planes, h2_planes, parts, outs):
    """Launch `plan`'s route of library `lib` (`_build.library()`, or the
    checked build): the f32 entry point ("sgemm") on h2 and w_t, or the
    bf16 one ("tma", "mma_sync" and the split routes) on h2, or on
    `h2_planes` (`split_bf16x3`'s (3, rows, R8)) where the plan takes
    three, and on w_t, or on `w_planes` ((3, R, V8)) where it takes three;
    into the caller's `parts` and `outs` (`vocab_buffers`' shapes;
    tools/memcheck.py passes guarded ones). Uncounted. Raises if the card
    refuses a launch."""
    rows, r = h2.shape
    v = w_t.shape[-1]
    ldw = w_t.stride(0) if r > 1 else v + -v % 8
    stream = torch.cuda.current_stream(h2.device).cuda_stream
    ptrs = tuple(t.data_ptr() for t in parts + outs) + (stream,)
    if plan.route == "sgemm":
        err = lib.vsrcic_vocab_topk(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
            int(w_t.dtype == torch.bfloat16), rows, r, v, ldw, k, *ptrs)
    else:
        lhs = h2_planes if plan.planes > 1 else h2
        rhs = w_planes if plan.w_planes > 1 else w_t
        if plan.w_planes > 1:
            ldw = w_planes.shape[-1]
        err = lib.vsrcic_vocab_topk_bf16(
            lhs.data_ptr(), rhs.data_ptr(), bias.data_ptr(), rows, r, v, ldw,
            k, int(plan.route != "mma_sync"), plan.tile_n, plan.planes,
            plan.w_planes, plan.stages, plan.cluster, plan.grid,
            plan.smem_bytes, *ptrs)
    _build.check(err, "vocab_topk_lse", lib)
