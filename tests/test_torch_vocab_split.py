"""The vocab head's split route (f32 h2 on a bf16 table), on the CPU.

`split_bf16x3_plain` writes an f32 h2 as three bf16 planes (hi, mid, lo)
whose sum is h2 exactly; the card multiplies each plane by the bf16 table on
the tensor cores, every product exact in f32, and sums the three into one
set of f32 accumulators. Here the same three products, upcast and summed in
f32 on the CPU (lo first, as the kernel sums them), are held to JAX's
`vocab_topk_lse_xla` on the f32 h2 and the upcast table: ids exact, values
and logsumexp within 1e-5. The plan tests pin the route each operand pair
and shape takes. The kernels themselves are held to the plain versions on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phase 3)."""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.vocab_topk import vocab_topk_lse_xla
from vsrcic_tpu_torch.core.nn import top_k
from vsrcic_tpu_torch.ops import vocab_topk as vt

from test_torch_vocab_nonfinite import CASES as NONFINITE, nonfinite_case
from torch_parity import vocab_case

BEAM = (5120, 1000, 10000, 5)
F32, BF16 = torch.float32, torch.bfloat16


def _values(seed, rows, r):
    """Signs and magnitudes 2^-100 .. 2^100, with +0 and -0 at the head of
    rows 0 and 1."""
    rng = np.random.RandomState(seed)
    e = rng.uniform(-100, 100, (rows, r))
    x = rng.choice([-1.0, 1.0], (rows, r)) * rng.uniform(1, 2, (rows, r))
    x = (x * 2.0 ** e).astype(np.float32)
    x[:2, 0] = [0.0, -0.0]
    return x


@pytest.mark.parametrize("seed,rows,r", [(0, 5, 1), (1, 7, 77), (2, 16, 1001),
                                         (3, 6, 64)])
def test_split_sums_back_exactly(seed, rows, r):
    x = _values(seed, rows, r)
    planes = vt.split_bf16x3_plain(torch.from_numpy(x))
    r8 = r + -r % 8
    assert planes.dtype == BF16 and tuple(planes.shape) == (3, rows, r8)
    assert not planes[:, :, r:].any()              # zero-padded to R8
    total = planes.double().sum(0)[:, :r].numpy()
    np.testing.assert_array_equal(total, x.astype(np.float64))
    assert np.signbit(planes[0, :2, 0].float().numpy()).tolist() == [
        False, True]
    # the residues shrink by 2^8 a plane: each has at most 8 bits
    hi, mid = planes[0].double(), planes[1].double()
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -7).all())
    # non-finite entries go whole into hi
    y = x.copy()
    y[2:5, 0] = [np.nan, np.inf, -np.inf]
    planes = vt.split_bf16x3_plain(torch.from_numpy(y))
    assert torch.isnan(planes[0, 2, 0])
    assert planes[0, 3:5, 0].float().tolist() == [math.inf, -math.inf]
    assert not planes[1:, 2:5, 0].any()


def _three_planes(h2, w_t, b, k):
    """The split route's function on the CPU: the planes' products with the
    table in f32, summed lo, mid, hi, plus the bias; top-k and
    logsumexp."""
    planes = vt.split_bf16x3_plain(h2).float()
    w = torch.nn.functional.pad(w_t.float(), (0, 0, 0, planes.shape[2]
                                              - w_t.shape[0]))
    logits = (planes[2] @ w + planes[1] @ w) + planes[0] @ w + b
    vals, ids = top_k(logits, k)
    return vals, ids.to(torch.int32), torch.logsumexp(logits, -1,
                                                      keepdim=True)


def _case(name):
    """(h2 f32, w_t f32 holding bf16 values, bias, k) as numpy."""
    if name.startswith("nonfinite_"):
        h2, w_t, b = nonfinite_case(name[len("nonfinite_"):])
        k = 5
    elif name == "ties_ragged":   # V a multiple of 8 (the route's), R 77
        rng = np.random.RandomState(11)
        h2 = rng.randn(40, 77).astype(np.float32)
        w_t = rng.randn(77, 392).astype(np.float32)
        b = rng.randn(392).astype(np.float32)
        for a, c in ((3, 10), (42, 170), (130, 390), (200, 201)):
            w_t[:, c] = w_t[:, a]
            b[c] = b[a]
        k = 5
    else:                         # tests/test_vocab_topk.py's tie cases
        h2, w_t, b, k, _ = vocab_case(name)
    w_t = torch.from_numpy(w_t).to(BF16).float().numpy()
    return h2, w_t, b, k


@pytest.mark.parametrize("name", ["ties", "multi_chunk", "row_blocked",
                                  "ties_ragged"]
                         + ["nonfinite_" + c for c in NONFINITE])
def test_three_planes_match_xla(name):
    h2, w_t, b, k = _case(name)
    with np.errstate(invalid="ignore"):
        want = [np.asarray(a) for a in vocab_topk_lse_xla(
            jnp.asarray(h2), jnp.asarray(w_t), jnp.asarray(b), k)]
    got = [a.numpy() for a in _three_planes(
        torch.from_numpy(h2), torch.from_numpy(w_t).to(BF16),
        torch.from_numpy(b), k)]
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        real = ~np.isnan(w)
        np.testing.assert_array_equal(np.signbit(g[real]),
                                      np.signbit(w[real]))


# (name, rows, R, V, k, h2 dtype, table dtype, W_t aligned, route)
ROUTES = [
    ("beam", *BEAM, F32, BF16, True, "split"),
    ("ragged_r", 37, 1001, 1000, 5, F32, BF16, True, "split"),
    ("tiny", 1, 1, 8, 8, F32, BF16, True, "split"),
    ("cli_v30", 2560, 1000, 30, 5, F32, BF16, True, "sgemm"),
    ("f32_table", *BEAM, F32, F32, True, "split9"),
    ("bf16_h2_f32_table", *BEAM, BF16, F32, True, "split_w"),
    ("unaligned_w", *BEAM, F32, BF16, False, "sgemm"),
    ("ragged_v", 37, 77, 1001, 5, F32, BF16, True, "sgemm"),
    ("bf16_operands", *BEAM, BF16, BF16, True, "tma"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[c[0] for c in ROUTES])
def test_route_plan(case):
    _, rows, r, v, k, lhs, table, aligned, route = case
    plan = vt.vocab_launch_plan(rows, r, v, k, lhs, table, aligned, 132)
    assert plan.route == route
    if route == "split":
        assert (plan.planes, plan.stages, plan.tile_n) == (
            vt.SPLIT_PLANES, vt.SPLIT_STAGES, vt.SPLIT_TILE_V)
        # clusters of two along the vocab, one where V is one tile
        assert plan.cluster == (vt.TMA_CLUSTER if v > vt.SPLIT_TILE_V
                                else 1) and plan.grid <= 132
        assert plan.smem_bytes <= vt.SMEM_MAX
    if route == "sgemm":
        assert plan.grid == math.ceil(rows / 128) * math.ceil(v / 128)
    walk = vt.tile_walk(plan, rows, v)
    seen = sorted(t for cta in walk for t in cta)
    assert seen == sorted((rb, c) for rb in range(math.ceil(rows / 128))
                          for c in range(math.ceil(v / plan.tile_n)))


@pytest.mark.parametrize("stages", [2, 3])
def test_split_ring_fits_and_matches_the_source(stages):
    """The split route's ring depths of the sweep (tools/ab_vocab.py):
    128-column tiles (csrc T_BN_SPLIT), the shared bytes the source
    computes, within the card's; stages of three planes' boxes fit no
    fourth slot."""
    src = (Path(vt.__file__).resolve().parent.parent / "csrc"
           / "vocab_topk.cu").read_text()
    for name, value in (("T_PLANES", vt.SPLIT_PLANES),
                        ("T_BN_SPLIT", vt.SPLIT_TILE_V),
                        ("T_MAX_STAGES", vt.TMA_MAX_STAGES)):
        assert int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1)) == value
    plan = vt._split_plan(*BEAM, True, 132, stages=stages)
    assert plan.tile_n == 128
    stage = (3 * 128 * 64 + 64 * 128) * 2
    assert plan.smem_bytes == 1024 + stages * (stage + 16) <= vt.SMEM_MAX
    for bad in (1, 4, 5):
        with pytest.raises(ValueError):
            vt._split_plan(*BEAM, True, 132, stages=bad)


@pytest.mark.parametrize("shape", [BEAM, (37, 1001, 1000, 5), (130, 77, 136, 16),
                                   (257, 64, 392, 3), (1, 8, 8, 8)])
@pytest.mark.parametrize("sms", [132, 7, 2])
def test_split_walk_covers_every_tile_once(shape, sms):
    """The split route's clusters run along the vocab (two tiles of one row
    block a group): every (row block, vocab tile) once, an odd tile count's
    last group half past V, whole clusters, loads within one group."""
    rows, r, v, k = shape
    plan = vt.vocab_launch_plan(rows, r, v, k, F32, BF16, True, sms)
    assert plan.route == "split" and plan.grid % plan.cluster == 0
    walk = vt.tile_walk(plan, rows, v)
    seen = [t for cta in walk for t in cta]
    n_rb, n_vt = math.ceil(rows / 128), math.ceil(v / 128)
    assert sorted(seen) == [(rb, c) for rb in range(n_rb)
                            for c in range(n_vt)]
    # the two CTAs of a cluster share a row block at every step
    for a, b in zip(walk[::2], walk[1::2]):
        assert [t[0] for t in a][:len(b)] == [t[0] for t in b]
