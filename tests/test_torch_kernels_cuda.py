"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA card and skip elsewhere. They import neither JAX nor the
JAX package (tests/conftest.py does, hence --noconftest), so they run where
the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from vsrcic_tpu_torch.ops.fused_attention import (
    fused_group_attention, fused_group_attention_plain)
from vsrcic_tpu_torch.ops.sinkhorn import (MAX_N, sinkhorn_normalize,
                                           sinkhorn_normalize_in_order,
                                           sinkhorn_normalize_plain)
from vsrcic_tpu_torch.ops.vocab_topk import (vocab_topk_lse,
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
        fa._launch(bad, *args, out, gsum)


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
    """bf16 h2 on an f32 table: h2 upcast, the f32 kernel (not counted as
    a bf16 launch), the same bits as the f32 kernel on the upcast h2."""
    h2, w_t, b, k, _ = vocab_case("ties")
    h2 = torch.from_numpy(h2).to(cuda_device, torch.bfloat16)
    w_t = torch.from_numpy(w_t).to(cuda_device)
    b = torch.from_numpy(b).to(cuda_device)
    before = (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16)
    got = vocab_topk_lse(h2, w_t, b, k)
    assert (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16) == (
        before[0] + 1, before[1])
    want = vocab_topk_lse(h2.float(), w_t, b, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
