"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA card and skip elsewhere. They import neither JAX nor the
JAX package (tests/conftest.py does, hence --noconftest), so they run where
the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from vsrcic_tpu_torch.ops import _build
from vsrcic_tpu_torch.ops.fused_attention import (
    fused_group_attention, fused_group_attention_plain)
from vsrcic_tpu_torch.ops.sinkhorn import (MAX_N, sinkhorn_normalize,
                                           sinkhorn_normalize_in_order,
                                           sinkhorn_normalize_plain)
from vsrcic_tpu_torch.ops import vocab_topk as vt
from vsrcic_tpu_torch.tools import memcheck
from vsrcic_tpu_torch.ops.vocab_topk import (padded_table, split_bf16x3,
                                             split_bf16x3_plain,
                                             table_planes,
                                             vocab_launch_plan,
                                             vocab_planes_plain,
                                             vocab_topk_lse,
                                             vocab_topk_lse_plain)

import torch_parity as tp
from torch_parity import cuda_device  # noqa: F401  (fixture)
from torch_parity import fused_inputs, fused_torch_args, vocab_case


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 20, 2048, 512),   # full widths
                                   (7, 5, 24, 100, 36)])     # ragged
def test_fused_attention_kernel_matches_plain(cuda_device, shape, table):
    rows, b, m, d, a = shape
    args = fused_torch_args(fused_inputs(m, seed=3, rows=rows, b=b, d=d, a=a),
                            table, cuda_device)
    before = fused_group_attention.launches
    got = fused_group_attention(*args)
    torch.cuda.synchronize()
    assert fused_group_attention.launches == before + 1
    want = fused_group_attention_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1024, 37, 1])
def test_fused_attention_kernel_beam1_matches_plain(cuda_device, b, table):
    """The trainers' decodes: beam 1, one row per item (rows = B), full
    widths (M 20, D 2048, A 512), B whole or ragged."""
    args = fused_torch_args(fused_inputs(20, seed=b, rows=b, b=b, d=2048,
                                         a=512), table, cuda_device)
    assert torch.equal(args[0].long(), torch.arange(b, device=cuda_device))
    before = fused_group_attention.launches
    got = fused_group_attention(*args)
    torch.cuda.synchronize()
    assert fused_group_attention.launches == before + 1
    want = fused_group_attention_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _fused_case(device, rows, b, m, d, a, table, ctrl_by="row", bad=(),
                seed=7):
    """Inputs from torch_parity.fused_inputs (item-major rows) with ctrl
    random per row ("row"), shared by an item's rows ("item") or every row
    on group (0, 0) ("one"); rows in `bad` get an item or ctrl out of
    range. att_a is scaled by 1 / sqrt(A), as the model's weights and
    chip_smoke.py phase 3's inputs are: unscaled, |det_w| ~ 15 and the
    order of its 512-term sums alone moves gate evidence by ~1e-5.
    Returns (the inputs the kernel gets, the valid rows' mask, the plain
    version's inputs with every index in range)."""
    import numpy as np
    args = list(fused_inputs(m, seed=seed, rows=rows, b=b, d=d, a=a))
    args[6] = (args[6] / np.sqrt(a)).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    if ctrl_by == "item":
        args[1] = rng.randint(0, tp.FA_L, b).astype(np.int32)[args[0]]
    elif ctrl_by == "one":
        args[0] = np.zeros(rows, np.int32)
        args[1] = np.zeros(rows, np.int32)
    plain_args = fused_torch_args(args, table, device)
    item, ctrl = args[0].copy(), args[1].copy()
    for k, r in enumerate(bad):
        if k % 3 == 0:
            item[r] = b
        elif k % 3 == 1:
            ctrl[r] = tp.FA_L
        else:
            item[r] = -1
    kern_args = list(plain_args)
    kern_args[0] = torch.from_numpy(item).to(device)
    kern_args[1] = torch.from_numpy(ctrl).to(device)
    ok = torch.ones(rows, dtype=torch.bool, device=device)
    ok[list(bad)] = False
    return kern_args, ok, plain_args


# (rows, B, M, D, A, ctrl_by): runs of rows on one group that cross the
# kernel's runs and clusters, every row on one group, M 1 and 33, D and A
# off the 16-byte rows of the bulk copies, one row
FUSED_CASES = [(37, 8, 24, 2048, 512, "item"), (2560, 512, 20, 2048, 512,
                                                "item"),
               (5120, 1707, 24, 2048, 512, "item"),
               (777, 3, 20, 2048, 512, "one"), (64, 13, 1, 2048, 512, "item"),
               (300, 60, 33, 2048, 512, "item"), (300, 43, 33, 1000, 100,
                                                  "item"),
               (11, 2, 3, 7, 3, "item"), (13, 4, 7, 130, 50, "row"),
               (1, 1, 20, 2048, 512, "row")]


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_attention_kernel_cases(cuda_device, case, table):
    rows, b, m, d, a, ctrl_by = case
    args, _, _ = _fused_case(cuda_device, rows, b, m, d, a, table, ctrl_by)
    index = [t.clone() for t in args[:2]]
    got = fused_group_attention(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(t, c) for t, c in zip(args[:2], index))
    want = fused_group_attention_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 8, 24, 2048, 512),
                                   (37, 8, 5, 100, 36)])
def test_fused_attention_out_of_range_rows(cuda_device, shape, table):
    """Rows whose item or ctrl is out of range, inside runs of rows on one
    group: NaN outputs, their neighbours exact, item / ctrl unchanged."""
    bad = (0, 2, 3, 17, 18, 19, 36)
    args, ok, plain_args = _fused_case(cuda_device, *shape, table, "item",
                                       bad)
    index = [t.clone() for t in args[:2]]
    got = fused_group_attention(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(t, c) for t, c in zip(args[:2], index))
    want = fused_group_attention_plain(*plain_args)
    for g, w in zip(got, want):
        assert torch.isnan(g[~ok]).all()
        torch.testing.assert_close(g[ok], w[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_fused_attention_refused_launch_raises(cuda_device):
    """A plan the entry point refuses (its shared bytes are not the
    kernel's layout) raises; nothing falls back to the plain version."""
    import dataclasses
    from vsrcic_tpu_torch.ops import fused_attention as fa
    args, _, _ = _fused_case(cuda_device, 8, 2, 5, 2048, 512,
                             torch.bfloat16)
    plan = fa.fused_launch_plan(8, 5, 2048, 512, 2)
    bad = dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16)
    out = torch.empty((8, 2048), device=cuda_device)
    gsum = torch.empty((8, 1), device=cuda_device)
    with pytest.raises(RuntimeError):
        fa._launch(_build.library(), bad, *args, out, gsum)


@pytest.mark.cuda
def test_xe_step_on_the_card(cuda_device):
    """One small XE step (lean compact path) on the card: finite losses,
    the same as on the CPU within rtol 1e-4."""
    from vsrcic_tpu_torch.models.captioner import init_captioner_params
    from vsrcic_tpu_torch.train.captioner import CaptionerXETrainer
    cfg = tp.train_cfg("torch")
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    losses = {}
    for dev in ("cpu", cuda_device):
        tr = CaptionerXETrainer(cfg, params, device=dev)
        losses[str(dev)] = [tr.step(*tp.xe_batch()) for _ in range(2)]
    got = torch.tensor(losses["cuda"])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.tensor(losses["cpu"]), rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_scst_step_on_the_card(cuda_device):
    """One small SCST step with fast_decode on the card: the decodes launch
    the fused kernel, 2 x seq_len times; loss and advantage finite."""
    from vsrcic_tpu_torch.models.captioner import init_captioner_params
    from vsrcic_tpu_torch.train.captioner import CaptionerSCSTTrainer
    cfg = tp.train_cfg("torch")
    tf, cider = tp.text_world("torch")
    det, grp, gts = tp.scst_batch()
    tr = CaptionerSCSTTrainer(
        cfg, init_captioner_params(torch.Generator().manual_seed(0), cfg),
        tf, cider, fast_decode=True, table_dtype=torch.bfloat16,
        device=cuda_device)
    before = fused_group_attention.launches
    loss, adv = tr.step(det, grp, gts,
                        torch.Generator(device=cuda_device).manual_seed(0))
    assert fused_group_attention.launches == before + 2 * cfg.seq_len
    assert torch.isfinite(torch.tensor([loss, adv])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_vocab_topk_kernel_matches_plain(cuda_device, case, table):
    h2, w_t, b, k, _ = vocab_case(case)
    args = (torch.from_numpy(h2).to(cuda_device),
            torch.from_numpy(w_t).to(cuda_device, table),
            torch.from_numpy(b).to(cuda_device))
    before = vocab_topk_lse.launches
    got = vocab_topk_lse(*args, k)
    torch.cuda.synchronize()
    assert vocab_topk_lse.launches == before + 1
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)


def _near_ties(h2, w_t, b, got, want, rtol):
    """Rows whose ids differ; each must be a near tie: the plain logit of
    every id the kernel chose within `rtol` of the plain value at its
    rank. Returns the count of such rows."""
    rows = torch.nonzero((got[1] != want[1]).any(1)).flatten()
    logits = h2[rows].float() @ w_t.float() + b
    for i, r in enumerate(rows.tolist()):
        lk = logits[i, got[1][r].long()]
        assert torch.all((lk - want[0][r]).abs()
                         <= rtol * want[0][r].abs()), r
    return int(rows.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_vocab_topk_bf16_kernel_matches_plain(cuda_device, case):
    """bf16 h2 and table: the tensor-core kernel, ids exact on the tie
    cases, values and lse at phase 3's bar."""
    h2, w_t, b, k, _ = vocab_case(case)
    args = (torch.from_numpy(h2).to(cuda_device, torch.bfloat16),
            torch.from_numpy(w_t).to(cuda_device, torch.bfloat16),
            torch.from_numpy(b).to(cuda_device))
    before = (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16)
    got = vocab_topk_lse(*args, k)
    torch.cuda.synchronize()
    assert (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 77, 1001, 5), (3, 1000, 130, 1),
                                   (101, 129, 257, 16), (130, 64, 136, 5),
                                   (512, 1000, 10000, 5)])
def test_vocab_topk_bf16_kernel_ragged(cuda_device, shape):
    """R not a multiple of 16 (77, 129: the slices' zero-filled depth), rows
    and V past a tile's edge, unaligned rows (element loads), k up to
    K_MAX; ids equal save near ties."""
    rows, r, v, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(rows + r)
    h2 = torch.randn((rows, r), generator=gen, device=cuda_device)
    w_t = torch.randn((r, v), generator=gen, device=cuda_device) / r ** 0.5
    b = torch.randn((v,), generator=gen, device=cuda_device)
    args = (h2.bfloat16(), w_t.bfloat16(), b)
    got = vocab_topk_lse(*args, k)
    torch.cuda.synchronize()
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    assert _near_ties(*args, got, want, 1e-5) <= rows // 100 + 1


@pytest.mark.cuda
def test_vocab_topk_bf16_lhs_on_f32_table(cuda_device):
    """bf16 h2 on an f32 table (padded to a pitch of 304): the "split_w"
    route (W_t's three planes, not counted as a bf16 launch), ids exact on
    the tie case, values and lse at phase 3's bar of the plain version
    (the f32 product of the upcast h2)."""
    h2, w_t, b, k, _ = vocab_case("ties")
    h2 = torch.from_numpy(h2).to(cuda_device, torch.bfloat16)
    w_t = padded_table(torch.from_numpy(w_t).to(cuda_device))   # V 300
    b = torch.from_numpy(b).to(cuda_device)
    before = (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16,
              vocab_topk_lse.launches_split_w)
    got = vocab_topk_lse(h2, w_t, b, k)
    assert (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16,
            vocab_topk_lse.launches_split_w) == (
        before[0] + 1, before[1], before[2] + 1)
    want = vocab_topk_lse_plain(h2.float(), w_t, b, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


ROUTE_COUNTS = ("launches", "launches_bf16", "launches_bf16_tma",
                "launches_split", "launches_split9", "launches_split_w",
                "launches_sgemm")


def _route(h2, w_t, k):
    """The route vocab_topk_lse takes on these operands (its own
    reading of their types and layout)."""
    lhs = h2.dtype
    if lhs == torch.bfloat16 and w_t.dtype == torch.float32 and \
            h2.data_ptr() % 16:
        lhs = torch.float32
    aligned = w_t.data_ptr() % 16 == 0 and (
        lhs == torch.float32 or h2.data_ptr() % 16 == 0)
    r, v = w_t.shape
    return vocab_launch_plan(h2.shape[0], h2.shape[1], v, k, lhs,
                             w_t.dtype, aligned, _build.sm_count(h2.device),
                             ldw=w_t.stride(0) if r > 1 else v + -v % 8
                             ).route


def _counted_call(h2, w_t, b, k, w_planes=None):
    """vocab_topk_lse, asserting its launch counts: one launch, counted on
    its route alone (bf16 launches: "tma" and "mma_sync"), and the split
    passes it makes: h2's on "split" and "split9", W_t's where its route
    takes W_t's planes and none were given."""
    route = _route(h2, w_t, k)
    before = [getattr(vocab_topk_lse, c) for c in ROUTE_COUNTS]
    passes = split_bf16x3.launches
    got = vocab_topk_lse(h2, w_t, b, k, w_planes=w_planes)
    torch.cuda.synchronize()
    want = [1, route in ("tma", "mma_sync"), route == "tma",
            route == "split", route == "split9", route == "split_w",
            route == "sgemm"]
    assert [getattr(vocab_topk_lse, c) - n
            for c, n in zip(ROUTE_COUNTS, before)] == want, route
    assert split_bf16x3.launches - passes == (
        (route in ("split", "split9"))
        + (route in ("split9", "split_w") and w_planes is None))
    return got, route


def _nonfinite_inputs(device, rows, r, v, case):
    """A 0/0 descriptor's NaN row 3, +-inf products in row 5 (one +inf
    entry), an all -inf row 7 ("rows"); or a NaN weight in column 9 and a
    +inf bias in the last column ("columns"); the NaNs made on the card."""
    rng = np.random.RandomState(rows + r + v)
    h2 = torch.from_numpy(np.tanh(rng.randn(rows, r)).astype(np.float32))
    w_t = torch.from_numpy((rng.randn(r, v) / r ** 0.5).astype(np.float32))
    b = torch.from_numpy((0.01 * rng.randn(v)).astype(np.float32))
    h2, w_t, b = h2.to(device), w_t.to(device), b.to(device)
    zero = torch.zeros((r,), device=device)
    if case == "rows":
        h2[3] = zero / zero
        h2[5] = 0.0
        h2[5, 2] = float("inf")
        h2[7] = 0.0
        h2[7, 4] = -float("inf")
        w_t[4] = w_t[4].abs() + 0.5
    else:
        w_t[6, 9] = zero[0] / zero[0]
        b[v - 1] = float("inf")
    return h2, w_t, b


@pytest.mark.cuda
@pytest.mark.parametrize("operands", ["f32", "f32_bf16table", "bf16",
                                      "bf16_f32table"])
@pytest.mark.parametrize("case", ["rows", "columns"])
@pytest.mark.parametrize("shape", [(300, 1000, 10000), (130, 64, 136),
                                   (37, 77, 1001)])
def test_vocab_topk_nonfinite_matches_plain(cuda_device, shape, case,
                                            operands):
    """Non-finite logits (ROADMAP §3 item 2) through every route: at the
    first two shapes "tma" (bf16), "split" (f32 h2, bf16 table), "split9"
    (f32 h2 and table) and "split_w" (bf16 h2, f32 table); at the ragged
    third (V 1001, unpadded) mma.sync and the SGEMM. Each against its plain
    version (the split routes on an f32 table against `vocab_planes_plain`,
    whose infinite h2 entries meet W_t's zero planes as the kernel's do):
    ids exact on the rows holding them, NaN and +-inf where the plain
    version has them, the finite rows around them at the bar; no id
    outside [0, V)."""
    rows, r, v = shape
    h2, w_t, b = _nonfinite_inputs(cuda_device, rows, r, v, case)
    if operands in ("f32_bf16table", "bf16"):
        w_t = w_t.bfloat16()
    if operands.startswith("bf16"):
        h2 = h2.bfloat16()
    got, route = _counted_call(h2, w_t, b, 5)
    want_route = {"bf16": "mma_sync" if r % 8 else "tma",
                  "f32_bf16table": "split", "f32": "split9",
                  "bf16_f32table": "split_w"}[operands]
    if v % 8:   # a contiguous W_t of V 1001: TMA cannot describe it
        want_route = "mma_sync" if operands == "bf16" else "sgemm"
    assert route == want_route
    plain = (vocab_planes_plain if route in ("split9", "split_w")
             else vocab_topk_lse_plain)
    want = plain(h2, w_t, b, 5)
    assert 0 <= int(got[1].min()) and int(got[1].max()) < v
    bad = ~torch.isfinite(h2.float() @ w_t.float() + b).all(1)
    assert int(bad.sum()) == (3 if case == "rows" else rows)
    torch.testing.assert_close(got[1][bad], want[1][bad], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    fin = ~bad
    if fin.any():
        assert _near_ties(h2[fin], w_t, b, (got[0][fin], got[1][fin]),
                          (want[0][fin], want[1][fin]), 1e-5) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [((5120, 1000, 10000, 5), "tma"),
                                         ((130, 64, 136, 16), "tma"),
                                         ((300, 64, 10000, 1), "tma"),
                                         ((37, 77, 1001, 5), "mma_sync"),
                                         ((24, 16, 260, 4), "mma_sync")])
def test_vocab_topk_bf16_routes(cuda_device, shape, route):
    """Each bf16 shape on the route its plan names, counted; the aligned
    shapes again from bases 2 bytes off 16 (mma.sync); values and lse at
    the bar, ids equal save near ties."""
    rows, r, v, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(rows + v)
    h2 = torch.randn((rows, r), generator=gen, device=cuda_device)
    w_t = torch.randn((r, v), generator=gen, device=cuda_device) / r ** 0.5
    b = torch.randn((v,), generator=gen, device=cuda_device)
    cases = [(h2.bfloat16(), w_t.bfloat16(), route)]
    if route == "tma":
        off = torch.empty(rows * r + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(rows, r)
        off.copy_(h2)
        cases.append((off, w_t.bfloat16(), "mma_sync"))
    for lhs, table, want_route in cases:
        got, taken = _counted_call(lhs, table, b, k)
        assert taken == want_route
        want = vocab_topk_lse_plain(lhs, table, b, k)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
        assert _near_ties(lhs, table, b, got, want, 1e-5) <= rows // 100 + 1


@pytest.mark.cuda
def test_vocab_topk_bf16_tma_ties(cuda_device):
    """Duplicated columns on the TMA route (V a multiple of 8): within a
    tile, across tiles and across the quad's lanes; ids exact."""
    rng = np.random.RandomState(11)
    rows, r, v, k = 40, 64, 392, 5
    h2 = rng.randn(rows, r).astype(np.float32)
    w_t = rng.randn(r, v).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    for a, c in ((3, 10), (42, 170), (5, 7), (130, 390), (200, 201)):
        w_t[:, c] = w_t[:, a]
        b[c] = b[a]
    top = (h2 @ w_t + b).argmax(1)
    for i in range(0, rows, 3):   # ties at rank 0 on some rows
        w_t[:, (top[i] + 129) % v] = w_t[:, top[i]]
        b[(top[i] + 129) % v] = b[top[i]]
    args = (torch.from_numpy(h2).to(cuda_device, torch.bfloat16),
            torch.from_numpy(w_t).to(cuda_device, torch.bfloat16),
            torch.from_numpy(b).to(cuda_device))
    got, route = _counted_call(*args, k)
    assert route == "tma"
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


def _split_values(device, rows, r, seed):
    """f32 h2 with every kind of entry the split pass meets: magnitudes
    2^-126 .. 2^127 of both signs, subnormals, +-0, +-inf and NaNs of both
    signs."""
    rng = np.random.RandomState(seed)
    e = rng.uniform(-126, 127, (rows, r))
    x = rng.choice([-1.0, 1.0], (rows, r)) * rng.uniform(1, 2, (rows, r))
    x = (x * 2.0 ** e).astype(np.float32)
    flat = x.reshape(-1)
    flat[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-42, 3.4e38, -1e-45]
    h2 = torch.from_numpy(x).to(device)
    zero = torch.zeros((), device=device)
    h2.view(-1)[8] = zero / zero
    h2.view(-1)[9] = -(zero / zero)
    return h2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,r,offset", [(5120, 1000, 0), (37, 1001, 0),
                                           (3, 77, 0), (130, 64, 1),
                                           (12, 1, 0)])
def test_vocab_split_planes_match_plain(cuda_device, rows, r, offset):
    """The card's split pass gives split_bf16x3_plain's planes bit for bit
    (on the card and on the CPU), ragged R zero-padded to R8, from aligned
    and unaligned (element-load) bases, on non-finite and subnormal
    entries too."""
    h2 = _split_values(cuda_device, rows, r, rows + r)
    if offset:
        h2 = torch.empty(rows * r + offset, device=cuda_device)[
            offset:].view(rows, r).copy_(h2)
    before = split_bf16x3.launches
    got = split_bf16x3(h2)
    torch.cuda.synchronize()
    assert split_bf16x3.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (
        3, rows, r + -r % 8)
    for want in (split_bf16x3_plain(h2), split_bf16x3_plain(h2.cpu())):
        assert torch.equal(got.view(torch.int16).cpu(),
                           want.view(torch.int16).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5120, 1000, 10000, 5),
                                   (37, 1001, 1000, 5), (130, 77, 136, 16),
                                   (300, 64, 10000, 1), (1, 8, 8, 8)])
@pytest.mark.parametrize("ring", ["plan", "two_slots"])
def test_vocab_topk_split_route(cuda_device, shape, ring):
    """f32 h2 on a bf16 table: the split route, counted, at the beam's
    shape, ragged R (zero-padded planes), rows past a tile and an odd
    vocab tile count; the plan's ring and the sweep's shallower one;
    values and lse at phase 3's bar, ids equal save near ties."""
    rows, r, v, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(rows + r + v)
    h2 = torch.tanh(torch.randn((rows, r), generator=gen,
                                device=cuda_device))
    w_t = (torch.randn((r, v), generator=gen, device=cuda_device)
           / r ** 0.5).bfloat16()
    b = 0.01 * torch.randn((v,), generator=gen, device=cuda_device)
    if ring == "plan":
        got, route = _counted_call(h2, w_t, b, k)
        assert route == "split"
    else:
        plan = vt._split_plan(rows, r, v, k, True,
                              _build.sm_count(cuda_device), stages=2)
        got = vt._run(plan, h2, w_t, b, k)
        torch.cuda.synchronize()
    want = vocab_topk_lse_plain(h2, w_t, b, k)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    assert _near_ties(h2, w_t, b, got, want, 1e-5) <= rows // 100 + 1


@pytest.mark.cuda
def test_vocab_topk_split_ties(cuda_device):
    """Duplicated columns on the split route (f32 h2, bf16 table, V a
    multiple of 8, R 77): within a tile, across tiles and across the
    quad's lanes; ids exact."""
    rng = np.random.RandomState(11)
    rows, r, v, k = 40, 77, 392, 5
    h2 = rng.randn(rows, r).astype(np.float32)
    w_t = rng.randn(r, v).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    for a, c in ((3, 10), (42, 170), (5, 7), (130, 390), (200, 201)):
        w_t[:, c] = w_t[:, a]
        b[c] = b[a]
    top = (h2 @ w_t + b).argmax(1)
    for i in range(0, rows, 3):   # ties at rank 0 on some rows
        w_t[:, (top[i] + 129) % v] = w_t[:, top[i]]
        b[(top[i] + 129) % v] = b[top[i]]
    args = (torch.from_numpy(h2).to(cuda_device),
            torch.from_numpy(w_t).to(cuda_device, torch.bfloat16),
            torch.from_numpy(b).to(cuda_device))
    got, route = _counted_call(*args, k)
    assert route == "split"
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


# (rows, R, V, k) of the padded tables' checks: the beam's shape, ragged R
# and V, V past one tile by one column, the CLI's V 30 and V 9999 (one
# column short of the beam's, rows 5 apart from a multiple of 8)
PLANE_SHAPES = [(5120, 1000, 10000, 5), (37, 1001, 1000, 5),
                (130, 77, 136, 16), (300, 64, 10000, 1), (1, 8, 8, 8),
                (2560, 1000, 30, 5), (64, 1000, 9999, 5), (40, 64, 129, 5)]
# the route each operand pair takes on a padded table (R a multiple of 8;
# ragged R: "split_w" -> "split9", "tma" -> "mma_sync")
PADDED_ROUTES = {"f32": "split9", "bf16_f32table": "split_w",
                 "f32_bf16table": "split", "bf16": "tma"}


def _vocab_operands(device, shape, operands):
    """(h2, w_t, bias, k, w_planes) as the captioner facade hands them
    over: h2 like the LSTM's output, an xavier-scaled table in a buffer of
    pitch V rounded up to 8 (`padded_table`), an f32 table's planes made
    once (`table_planes`)."""
    rows, r, v, k = shape
    gen = torch.Generator(device=device).manual_seed(rows + r + v)
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device=device))
    w = torch.randn((r, v), generator=gen, device=device) / r ** 0.5
    b = 0.01 * torch.randn((v,), generator=gen, device=device)
    table = (torch.bfloat16 if operands in ("f32_bf16table", "bf16")
             else torch.float32)
    w_t = padded_table(w, table)
    assert w_t.stride(0) == v + -v % 8 and w_t.data_ptr() % 16 == 0
    lhs = h2.bfloat16() if operands.startswith("bf16") else h2
    planes = table_planes(w_t) if table == torch.float32 else None
    return lhs, w_t, b, k, planes


@pytest.mark.cuda
@pytest.mark.parametrize("operands", list(PADDED_ROUTES))
@pytest.mark.parametrize("shape", PLANE_SHAPES)
def test_vocab_topk_padded_table_routes(cuda_device, shape, operands):
    """Every operand pair on a padded table takes its TMA route at any V
    (V 30 and 129: one tile, or one column past it; clusters of one CTA
    along the vocab at V <= 128), counted; ragged R moves "split_w" to
    "split9" and "tma" to mma.sync. Values and lse at phase 3's bar of the
    plain version, ids equal save near ties."""
    h2, w_t, b, k, planes = _vocab_operands(cuda_device, shape, operands)
    got, route = _counted_call(h2, w_t, b, k, w_planes=planes)
    want_route = PADDED_ROUTES[operands]
    if shape[1] % 8:
        want_route = {"split_w": "split9", "tma": "mma_sync"}.get(
            want_route, want_route)
    assert route == want_route
    want = vocab_topk_lse_plain(h2, w_t, b, k)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    assert _near_ties(h2, w_t, b, got, want, 1e-5) <= shape[0] // 100 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("operands", ["f32", "bf16_f32table",
                                      "f32_bf16table"])
def test_vocab_topk_planes_ties(cuda_device, operands):
    """Duplicated columns on the split routes at a ragged V (390, padded):
    within a tile, across tiles and across the quad's lanes; ids exact."""
    rng = np.random.RandomState(11)
    rows, r, v, k = 40, 64, 390, 5
    h2 = rng.randn(rows, r).astype(np.float32)
    w = rng.randn(r, v).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    for a, c in ((3, 10), (42, 170), (5, 7), (130, 389), (200, 201)):
        w[:, c] = w[:, a]
        b[c] = b[a]
    top = (h2 @ w + b).argmax(1)
    for i in range(0, rows, 3):   # ties at rank 0 on some rows
        w[:, (top[i] + 129) % v] = w[:, top[i]]
        b[(top[i] + 129) % v] = b[top[i]]
    table = torch.bfloat16 if operands == "f32_bf16table" else torch.float32
    lhs = torch.from_numpy(h2).to(cuda_device)
    if operands == "bf16_f32table":
        lhs = lhs.bfloat16()
    w_t = padded_table(torch.from_numpy(w).to(cuda_device), table)
    b = torch.from_numpy(b).to(cuda_device)
    got, route = _counted_call(lhs, w_t, b, k)
    assert route == PADDED_ROUTES[operands]
    want = vocab_topk_lse_plain(lhs, w_t, b, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v", [(1000, 10000), (77, 1001), (1000, 30),
                                 (5, 9)])
def test_table_planes_match_plain(cuda_device, r, v):
    """An f32 table's planes on the card (the split pass on a padded
    table's rows) equal split_bf16x3_plain's bit for bit, on every kind of
    entry, zero past V."""
    w = _split_values(cuda_device, r, v, r + v)
    before = split_bf16x3.launches
    got = table_planes(padded_table(w))
    torch.cuda.synchronize()
    assert split_bf16x3.launches == before + 1
    assert tuple(got.shape) == (3, r, v + -v % 8)
    want = split_bf16x3_plain(w.cpu())
    assert torch.equal(got.view(torch.int16).cpu(), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
def test_vocab_topk_sgemm_only_where_tma_cannot_read(cuda_device, table):
    """f32 h2 on a table takes the SGEMM only where TMA cannot read it: a
    contiguous W_t at V 1001 (rows 1001 apart) or an unaligned base; the
    same values padded take the split route of the table's type. All at
    phase 3's bar of the plain version, ids equal save near ties."""
    rows, r, v, k = 64, 77, 1001, 5
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    h2 = torch.tanh(torch.randn((rows, r), generator=gen,
                                device=cuda_device))
    w = (torch.randn((r, v), generator=gen, device=cuda_device)
         / r ** 0.5).to(table)
    b = 0.01 * torch.randn((v,), generator=gen, device=cuda_device)
    pitch = v + -v % 8
    unaligned = torch.zeros(r * pitch + 1, dtype=table,
                            device=cuda_device)[1:].as_strided(
                                (r, v), (pitch, 1))
    unaligned.copy_(w)
    split = "split9" if table == torch.float32 else "split"
    for w_t, want_route in ((w, "sgemm"), (unaligned, "sgemm"),
                            (padded_table(w), split)):
        got, route = _counted_call(h2, w_t, b, k)
        assert route == want_route
        want = vocab_topk_lse_plain(h2, w_t, b, k)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
        assert _near_ties(h2, w_t, b, got, want, 1e-5) <= 1


@pytest.mark.cuda
def test_vocab_topk_infinite_weight_meets_zero_planes(cuda_device):
    """The nine-plane route's documented difference (ROADMAP §3): an
    infinite f32 weight goes whole into W_t's hi plane and meets the zero
    mid and lo planes of an h2 exact in bf16: 0 x inf = NaN, where the f32
    product gives +-inf. The kernel gives vocab_planes_plain's NaN."""
    rows, r, v, k = 8, 64, 136, 5
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    h2 = torch.randn((rows, r), generator=gen, device=cuda_device)
    h2[:, 3] = h2[:, 3].abs() + 0.5   # every row meets the weight: +inf
    h2 = h2.bfloat16().float()
    w = torch.randn((r, v), generator=gen, device=cuda_device) / 8
    w[3, 7] = float("inf")
    b = torch.zeros((v,), device=cuda_device)
    w_t = padded_table(w)
    got, route = _counted_call(h2, w_t, b, k)
    assert route == "split9"
    f32 = vocab_topk_lse_plain(h2, w_t, b, k)
    replay = vocab_planes_plain(h2, w_t, b, k)
    assert torch.isinf(f32[2]).all() and torch.isnan(replay[2]).all()
    assert torch.isnan(got[2]).all()
    torch.testing.assert_close(got[1], replay[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [None, torch.bfloat16])
@pytest.mark.parametrize("v", [29, 30])
def test_facade_beam_takes_no_sgemm(cuda_device, table, v):
    """The facade's beam with the kernels on f32 and bf16 tables at V 29
    and 30 (the tables padded once, an f32 table's planes made once): every
    vocab launch on the split route of its tables, no SGEMM; words and
    gates those of the plain versions' beam."""
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    cfg = CaptionerConfig(seq_len=tp.T, vocab_size=v, bos_idx=tp.BOS,
                          det_feat_size=tp.D, input_encoding_size=tp.E,
                          rnn_size=tp.R, att_size=tp.A)
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    det, groups, verb_list = tp.inputs(3)
    res = {}
    for mode in (True, "plain"):
        cap = ControllableCaptioner(
            cfg, params=params, verb_2_vob_all=tp.VERB_TABLE,
            use_fused_attention=mode, use_vocab_topk=mode, table_dtype=table,
            device=cuda_device)
        before = [getattr(vocab_topk_lse, c) for c in ROUTE_COUNTS]
        res[mode] = cap.beam_search_v(det, groups, verb_list,
                                      eos_word=tp.EOS, beam_size=5)
        torch.cuda.synchronize()
        counts = dict(zip(ROUTE_COUNTS, [
            getattr(vocab_topk_lse, c) - n
            for c, n in zip(ROUTE_COUNTS, before)]))
        w_t, _ = cap._vocab_tables
        assert w_t.stride(0) == v + -v % 8 and w_t.data_ptr() % 16 == 0
        split = "launches_split" if table else "launches_split9"
        want = tp.T if mode is True else 0
        assert counts == {c: want if c in ("launches", split) else 0
                          for c in ROUTE_COUNTS}
    for f in ("words", "gates"):
        assert torch.equal(getattr(res[True], f), getattr(res["plain"], f))


@pytest.mark.cuda
@pytest.mark.parametrize("table", [None, torch.bfloat16])
@pytest.mark.parametrize("v", [29, 30])
def test_facade_vocab_nonfinite_table(cuda_device, table, v):
    """A captioner whose out_fc table holds -inf: the facade reads it once
    and sends an f32 h2 to the SGEMM on f32 and bf16 tables. On an h2 exact
    in bf16 whose entry meets the weight (> 0, 0 and < 0 by row: -inf, NaN,
    +inf logits, where the split routes' zero planes give NaN on every
    row), its vocab function gives vocab_topk_lse_plain's values and
    logsumexp (+-inf and NaN where it has them) and its ids exactly; its
    beam launches the SGEMM alone, no split route and no split pass, and
    gives the plain versions' words and gates."""
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    cfg = CaptionerConfig(seq_len=tp.T, vocab_size=v, bos_idx=tp.BOS,
                          det_feat_size=tp.D, input_encoding_size=tp.E,
                          rnn_size=tp.R, att_size=tp.A)
    params = tp.infinite_weight(init_captioner_params(
        torch.Generator().manual_seed(0), cfg), tp.R)
    caps = {mode: ControllableCaptioner(
        cfg, params=params, verb_2_vob_all=tp.VERB_TABLE,
        use_fused_attention=mode, use_vocab_topk=mode, table_dtype=table,
        device=cuda_device) for mode in (True, "plain")}
    fn, (w_t, b) = caps[True]._vocab_fn_and_tables(5)
    assert caps[True]._finite_table is False
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    h2 = torch.randn((40, tp.R), generator=gen, device=cuda_device)
    h2[:, 3] = h2[:, 3].abs() + 0.5
    h2[1::5, 3] = 0.0
    h2[2::5, 3] = -h2[2::5, 3]
    h2 = h2.bfloat16().float()
    before = [getattr(vocab_topk_lse, c) for c in ROUTE_COUNTS]
    passes = split_bf16x3.launches
    got = fn(h2, w_t, b)
    torch.cuda.synchronize()
    assert [getattr(vocab_topk_lse, c) - n for c, n in
            zip(ROUTE_COUNTS, before)] == [1, 0, 0, 0, 0, 0, 1]
    assert split_bf16x3.launches == passes
    want = vocab_topk_lse_plain(h2, w_t, b, 5)
    lse = want[2].flatten()
    assert torch.isnan(lse[1::5]).all() and torch.isposinf(lse[2::5]).all()
    assert torch.isfinite(lse[0::5]).all()
    assert torch.isnan(vocab_planes_plain(h2, w_t, b, 5)[2]).all()
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
    assert torch.equal(got[1], want[1])
    det, groups, verb_list = tp.inputs(3)
    res = {}
    for mode, cap in caps.items():
        before = [getattr(vocab_topk_lse, c) for c in ROUTE_COUNTS]
        passes = split_bf16x3.launches
        res[mode] = cap.beam_search_v(det, groups, verb_list,
                                      eos_word=tp.EOS, beam_size=5)
        torch.cuda.synchronize()
        counts = dict(zip(ROUTE_COUNTS, [
            getattr(vocab_topk_lse, c) - n
            for c, n in zip(ROUTE_COUNTS, before)]))
        want = tp.T if mode is True else 0
        assert counts == {c: want if c in ("launches", "launches_sgemm")
                          else 0 for c in ROUTE_COUNTS}
        assert split_bf16x3.launches == passes
    for f in ("words", "gates"):
        assert torch.equal(getattr(res[True], f), getattr(res["plain"], f))
    assert not (res[True].words == 20).any()


@pytest.mark.cuda
def test_vocab_topk_refuses_what_it_cannot_take(cuda_device):
    h2 = torch.zeros((4, 16), device=cuda_device)
    w_t = torch.zeros((16, 40), device=cuda_device)
    b = torch.zeros((40,), device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        vocab_topk_lse(h2.half(), w_t, b, 5)
    with pytest.raises(ValueError, match="bfloat16"):
        vocab_topk_lse(h2.bfloat16(), w_t.double(), b, 5)
    with pytest.raises(ValueError, match="bias"):
        vocab_topk_lse(h2.bfloat16(), w_t.bfloat16(), b.bfloat16(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        vocab_topk_lse(h2.bfloat16(),
                       w_t.bfloat16().t().contiguous().t(), b, 5)
    out = vocab_topk_lse(h2[:0].bfloat16(), w_t.bfloat16(), b, 5)
    assert [tuple(x.shape) for x in out] == [(0, 5), (0, 5), (0, 1)]


# n at the edges of the kernel's packing: 32 // n matrices per warp up to
# n = 16, one per warp up to 32, one block per matrix above
SINK_N = [1, 2, 3, 10, 11, 16, 17, 31, 32, 33, 64, 241]


def sink_scores(device, s, n, seed):
    """Scores as sinkhorn_net_apply hands them over: tanh, in (-1, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.tanh(torch.randn((s, n, n), generator=gen, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SINK_N)
@pytest.mark.parametrize("s", [1, 7, 1536, 1537])
def test_sinkhorn_kernel_matches_plain(cuda_device, s, n):
    """Within 1e-6 of the plain version on scores in (-1, 1), with S a
    whole number of warps' groups or not."""
    x = sink_scores(cuda_device, s, n, seed=n)
    before = sinkhorn_normalize.launches
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert sinkhorn_normalize.launches == before + 1
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, 20, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 10, 16, 17, 32, 33])
def test_sinkhorn_kernel_equals_its_arithmetic_replayed(cuda_device, n):
    """Sums in index order and correctly rounded divisions, as the replay
    does them one IEEE operation at a time: the same bits."""
    x = sink_scores(cuda_device, 1537, n, seed=2 * n)
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, sinkhorn_normalize_in_order(x, 20, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 1])
@pytest.mark.parametrize("n", [3, 10, 17, 33])
def test_sinkhorn_kernel_few_iterations(cuda_device, n, n_iters):
    """No iteration is exp(x / tau) alone; one is one column and one row
    pass."""
    x = sink_scores(cuda_device, 1537, n, seed=n_iters)
    got = sinkhorn_normalize(x, n_iters, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, n_iters, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10, 17, 33])
def test_sinkhorn_kernel_equal_scores_give_uniform(cuda_device, n):
    x = torch.full((1537, n, n), 0.3, device=cuda_device)
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, torch.full_like(x, 1.0 / n), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, 20, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 33])
def test_sinkhorn_kernel_is_deterministic(cuda_device, n):
    x = sink_scores(cuda_device, 1536, n, seed=5)
    first = sinkhorn_normalize(x, 20, 0.1)
    second = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_sinkhorn_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((4, 10, 10), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_normalize(x.double(), 20, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_normalize(x.transpose(1, 2), 20, 0.1)
    with pytest.raises(ValueError, match="exceeds"):
        sinkhorn_normalize(torch.zeros((1, MAX_N + 1, MAX_N + 1),
                                       device=cuda_device), 20, 0.1)


@pytest.mark.cuda
def test_sinkhorn_autograd_through_the_kernel(cuda_device):
    """The autograd Function on the card: one kernel launch forward, values
    within 1e-6 of the plain version's, and the gradient of the plain
    version replayed, the same bits as autograd through the plain version
    (the backward runs those very operations)."""
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize_grad
    x = sink_scores(cuda_device, 1536, 10, seed=7)
    w = torch.randn(x.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(8), device=cuda_device)
    outs = []
    for fn in (sinkhorn_normalize_grad, sinkhorn_normalize_plain):
        xt = x.clone().requires_grad_(True)
        before = sinkhorn_normalize.launches
        y = fn(xt, 20, 0.1)
        (g,) = torch.autograd.grad((y * w).sum(), xt)
        torch.cuda.synchronize()
        outs.append((y.detach(), g, sinkhorn_normalize.launches - before))
    assert [o[2] for o in outs] == [1, 0]
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-6)
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_sinkhorn_trainer_step_on_the_card(cuda_device):
    """One SinkhornTrainer step at the pipeline tests' reduced width: the
    loss and gradients through the kernel against the plain version on the
    card (loss within rtol 1e-5, gradients within rtol 1e-4 / atol 1e-6),
    one launch per step, and the step's loss the CPU trainer's within rtol
    1e-4."""
    from vsrcic_tpu_torch.models.sinkhorn import init_sinkhorn_params
    from vsrcic_tpu_torch.train.planners import SinkhornTrainer
    from vsrcic_tpu_torch.utils.params import flatten
    cfg = tp.sink_cfg("torch")
    params = init_sinkhorn_params(torch.Generator().manual_seed(0), cfg)
    batch = tp.sinkhorn_train_batch(
        3, 9, width=cfg.txt_dim + cfg.vis_dim + cfg.pos_dim)
    tr = SinkhornTrainer(cfg, params, lr=1e-3, device=cuda_device)
    got = tr.loss_and_grads(*batch, n_images=4)
    want = tr.loss_and_grads(*batch, n_images=4,
                             normalize=sinkhorn_normalize_plain)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    g, w = flatten(got[1]), flatten(want[1])
    for k in w:
        torch.testing.assert_close(g[k], w[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
    before = sinkhorn_normalize.launches
    loss = tr.step(*batch, n_images=4)
    assert sinkhorn_normalize.launches == before + 1
    cpu = SinkhornTrainer(cfg, params, lr=1e-3, device="cpu")
    torch.testing.assert_close(torch.tensor(loss),
                               torch.tensor(cpu.step(*batch, n_images=4)),
                               rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_ssp_trainer_step_on_the_card(cuda_device):
    """Two SSPTrainer steps with dropout 0 (the small planner): the CPU
    trainer's losses within rtol 1e-4; with dropout 0.1 and a generator on
    the card, a finite loss."""
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.train.planners import SSPTrainer
    cfg = SSPConfig(**dict(tp.SSP_KW, dropout=0.0))
    params = init_ssp_params(torch.Generator().manual_seed(0), cfg)
    batch = tp.ssp_train_batch(2, 10)
    losses = {}
    for dev in ("cpu", cuda_device):
        tr = SSPTrainer(cfg, params, lr=1e-3, device=dev)
        losses[str(dev)] = [tr.step(*batch, None) for _ in range(2)]
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]), rtol=1e-4, atol=0)
    tr = SSPTrainer(SSPConfig(**tp.SSP_KW), params, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    assert torch.isfinite(torch.tensor(tr.step(*batch, gen)))


@pytest.mark.cuda
@pytest.mark.parametrize("dataset", ["coco", "flickr"])
def test_eval_cli_golden_on_the_card(cuda_device, dataset, tmp_path):
    """The eval CLI on the card from its golden fixture: the fast flags
    launch all three kernels and dump the captions of JAX's Pallas kernels
    (ids exact); the strict run dumps JAX's strict captions."""
    from vsrcic_tpu_torch.cli import eval as eval_cli
    from vsrcic_tpu_torch.tools.eval_checkpoints import (golden_flags,
                                                         load_golden)
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize as sink
    g = load_golden()
    flags = golden_flags(g, dataset, str(tmp_path))
    for mode, extra in (("strict", []), ("fast", tp.EVAL_CLI_FAST)):
        kernels = (fused_group_attention, vocab_topk_lse, sink)
        before = [k.launches for k in kernels]
        got = tp.run_eval_cli(eval_cli.main, flags + extra,
                              tmp_path / "dump.jsonl")
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert got["dump"] == tp.golden_eval_cli_result(
            g, dataset, mode)["dump"]
        assert launched[2] > 0
        assert (min(launched) > 0) if extra else launched[:2] == [0, 0]


TRAIN_CLI_TINY = ["--synthetic", "--synthetic_images", "16", "--batch_size",
                  "8", "--seed", "7", "--rnn_size", "16", "--att_size", "8",
                  "--input_encoding_size", "16"]


@pytest.mark.cuda
def test_train_cli_lifecycle_on_the_card(cuda_device, tmp_path):
    """The tiny XE -> SCST --fast_decode -> Sinkhorn lifecycle through the
    train CLIs on the card (no --platform): XE writes exp_best and runs no
    kernel; SCST restores it, launches the fused kernel 40 times a step (a
    greedy and a sampled decode of 20 steps) and writes exp_rl_last; the
    Sinkhorn CLI launches its kernel once a step; every logged loss is
    finite."""
    import math
    import os
    from vsrcic_tpu_torch.cli import train, train_sinkhorn
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize as sink
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    root = str(tmp_path / "saved")
    kernels = (fused_group_attention, vocab_topk_lse, sink)
    runs = (("xe", train.main, ["--max_epochs", "1"], (0, 0, 0)),
            ("scst", train.main, ["--sample_rl", "--fast_decode",
                                  "--max_steps", "2", "--max_epochs", "1"],
             (80, 0, 0)),
            ("sinkhorn", train_sinkhorn.main, ["--max_steps", "2"],
             (0, 0, 2)))
    out = {}
    for name, main, extra, want in runs:
        before = [k.launches for k in kernels]
        res = out[name] = g.run_captured(
            main, ["--dataset", "coco", "--checkpoint_path", root,
                   "--log_dir", str(tmp_path / name)]
            + extra + TRAIN_CLI_TINY)
        launched = tuple(k.launches - b for k, b in zip(kernels, before))
        assert launched == want, (name, launched)
        assert res["losses"] and all(map(math.isfinite, res["losses"]))
    assert any(ln.startswith("restored XE best") for ln in out["scst"]["out"])
    for rel in ("coco_cap/exp_best", "coco_cap/exp_rl_last",
                "coco_sinkhorn/model-sh"):
        assert os.path.isfile(os.path.join(root, rel + ".npz")), rel


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["xe", "sinkhorn_coco", "sinkhorn_flickr"])
def test_train_cli_golden_on_the_card(cuda_device, run, tmp_path):
    """The train CLIs' golden fixture (the JAX CLIs' runs) replayed on the
    card: losses within rtol 1e-4, saved weights within rtol 1e-4 / atol
    1e-6, XE's validation lines equal; the Sinkhorn runs through the
    kernel."""
    from vsrcic_tpu_torch.cli import train, train_sinkhorn
    from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize as sink
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    golden = g.load_golden()
    main = train.main if run == "xe" else train_sinkhorn.main
    before = sink.launches
    res = g.run_captured(main, g.golden_flags(golden, run, str(tmp_path)))
    g.check_run(run, res, g.saved_params(str(tmp_path), run),
                *g.golden_run(golden, run))
    assert sink.launches - before == (0 if run == "xe"
                                      else len(res["losses"]))


# ---------------------------------------------------------------------------
# the memory check (tools/memcheck.py, csrc/check.cuh's checked build)
# ---------------------------------------------------------------------------

MEMCHECK_CUTS = sorted(memcheck.cut_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,bound", MEMCHECK_CUTS,
                         ids=lambda v: str(v))
def test_memcheck_cut_bound_faults(cuda_device, kernel, bound):
    """A bound the checked build derives (or a tensor map's extent), cut
    by one element through the checked build's setter, faults in that
    kernel with that kind of access; the work is unchanged, guarded
    buffers keep it from touching anything else, and once the cut is
    restored the case runs clean."""
    lib = _build.library(checked=True)
    case, kind = memcheck.cut_cases(_build.sm_count(cuda_device))[
        kernel, bound]
    res = memcheck.run_case(case, lib,
                            cut_bound=(memcheck.KERNELS.index(kernel), bound))
    hits = [r for _, r in res["faults"]
            if memcheck.KERNELS[r.kernel] == kernel and r.bound_id == bound]
    assert hits, res
    assert memcheck.KINDS[hits[0].kind] == kind
    assert hits[0].index >= hits[0].bound
    assert res["breaches"] == 0 and not res["changed"], res
    clean = memcheck.run_case(case, lib)
    assert clean["ok"], clean


@pytest.mark.cuda
def test_memcheck_sweep_subset_is_clean(cuda_device):
    """Every 23rd case of the sweep on the checked build and guarded
    buffers: no fault, no guard breach, no changed input, outputs at
    phase 3's tolerances."""
    lib = _build.library(checked=True)
    results, counts, failures = memcheck.sweep(lib, every=23)
    assert not failures, failures
    assert len(results) >= 20


@pytest.mark.cuda
def test_default_library_has_no_checks(cuda_device):
    """The main path's library is the default build: no check records."""
    assert not hasattr(_build.library(), "vsrcic_check_read")
    assert hasattr(_build.library(checked=True), "vsrcic_check_read")
