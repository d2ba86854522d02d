"""The vocab head's f32 tables on the tensor cores, and tables of any V, on
the CPU.

An f32 W_t splits exactly into three bf16 planes, as an f32 h2 does
(`split_bf16x3`); every bf16 x bf16 product is exact in f32, so the card
computes JAX's f32 product on an f32 table as nine plane products ("split9":
f32 h2) or three ("split_w": bf16 h2), summed in f32. Here the planes' sums
are held to W_t bit for bit, and `vocab_planes_plain`, the replay of those
products in f32 (the lightest first, as each stage of the kernel sums
them), to JAX's `vocab_topk_lse_xla`. The captioner facade stores every
table once at a pitch of V rounded up to 8 (`padded_table`), so that TMA
reads any V, and an f32 table's planes once beside it; the CPU beam keeps
JAX's tokens at a V that is no multiple of 8. The plan tests pin each
route, the rings and the walks. The kernels themselves are held to these
plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py phase 3)."""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.vocab_topk import vocab_topk_lse_xla
from vsrcic_tpu_torch.ops import vocab_topk as vt

import torch_parity as tp
from torch_parity import vocab_case
from test_torch_vocab_split import _values

F32, BF16 = torch.float32, torch.bfloat16
BEAM = (5120, 1000, 10000, 5)


@pytest.mark.parametrize("seed,r,v", [(0, 7, 29), (1, 77, 1001), (2, 16, 8),
                                      (3, 2, 30)])
def test_table_planes_sum_back_exactly(seed, r, v):
    """W_t's planes (3, R, V8) from its padded table: their sum is W_t bit
    for bit (magnitudes 2^-100 .. 2^100, +-0), zero past V; a non-finite
    weight goes whole into hi."""
    w = _values(seed, r, v)
    w[0, -1] = np.inf
    w_t = vt.padded_table(torch.from_numpy(w))
    planes = vt.table_planes(w_t)
    v8 = v + -v % 8
    assert planes.dtype == BF16 and tuple(planes.shape) == (3, r, v8)
    assert not planes[:, :, v:].any()
    fin = np.isfinite(w)
    total = planes.double().sum(0)[:, :v].numpy()
    np.testing.assert_array_equal(total[fin], w[fin].astype(np.float64))
    np.testing.assert_array_equal(
        np.signbit(planes[0, :, :v].float().numpy()), np.signbit(w))
    assert (planes[0, :, :v].float().numpy()[~fin] == w[~fin]).all()
    assert not planes[1:, :, :v].float().numpy()[:, ~fin].any()


def _case(name):
    """(h2 f32, w_t f32, bias, k, ids exact) as numpy."""
    if name in ("ties", "multi_chunk", "row_blocked"):
        h2, w_t, b, k, _ = vocab_case(name)
        return h2, w_t, b, k, True
    rng = np.random.RandomState(13)
    if name == "ties_ragged":     # V 389: padded, duplicates across tiles
        h2 = rng.randn(40, 77).astype(np.float32)
        w_t = rng.randn(77, 389).astype(np.float32)
        b = rng.randn(389).astype(np.float32)
        for a, c in ((3, 10), (42, 170), (130, 388), (200, 201)):
            w_t[:, c] = w_t[:, a]
            b[c] = b[a]
        return h2, w_t, b, 5, True
    # "wide": the beam's R, a ragged V, xavier-scaled weights: near ties
    # allowed
    h2 = np.tanh(rng.randn(64, 1000)).astype(np.float32)
    w_t = (rng.randn(1000, 999) * (2.0 / 10999) ** 0.5).astype(np.float32)
    b = (0.01 * rng.randn(999)).astype(np.float32)
    return h2, w_t, b, 5, False


CASES = ["ties", "multi_chunk", "row_blocked", "ties_ragged", "wide"]


@pytest.fixture(scope="module")
def xla():
    """JAX's reference on each case, for f32 h2 and for h2 rounded to bf16
    (both on the f32 table), computed once."""
    out = {}
    for name in CASES:
        h2, w_t, b, k, _ = _case(name)
        h2_bf16 = torch.from_numpy(h2).to(BF16).float().numpy()
        for lhs, x in (("f32", h2), ("bf16", h2_bf16)):
            out[name, lhs] = [np.asarray(a) for a in vocab_topk_lse_xla(
                jnp.asarray(x), jnp.asarray(w_t), jnp.asarray(b), k)]
    return out


@pytest.mark.parametrize("lhs", ["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_plane_products_match_xla(xla, name, lhs):
    """The replay of "split9" (f32 h2: nine products) and "split_w" (h2
    rounded to bf16: three) on an f32 table against JAX's f32 product:
    ids exact on the tie cases, equal save near ties on the wide one (the
    logit of each id within 1e-5 relative of JAX's value at its rank);
    values and logsumexp within rtol 1e-5 / atol 1e-6."""
    h2, w_t, b, k, exact = _case(name)
    th2 = torch.from_numpy(h2)
    if lhs == "bf16":
        th2 = th2.to(BF16)
    got = [a.numpy() for a in vt.vocab_planes_plain(
        th2, torch.from_numpy(w_t), torch.from_numpy(b), k)]
    want = xla[name, lhs]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    if exact:
        np.testing.assert_array_equal(got[1], want[1])
        return
    logits = th2.double().numpy() @ w_t.astype(np.float64) + b
    rows = np.nonzero((got[1] != want[1]).any(1))[0]
    assert len(rows) <= 1
    for r in rows:
        np.testing.assert_allclose(logits[r, got[1][r]], want[0][r],
                                   rtol=1e-5, atol=0)


def test_infinite_weight_meets_zero_planes():
    """The nine-plane function's one difference from the f32 product
    (ROADMAP §3): an infinite weight goes whole into W_t's hi plane and
    meets the zero mid and lo planes of an h2 exact in bf16, 0 x inf =
    NaN, where the f32 product (JAX's and the plain version's) gives
    +-inf; an infinite h2 entry meets W_t's zero planes alike. Finite rows
    and columns keep the f32 product's values."""
    rng = np.random.RandomState(3)
    h2 = torch.from_numpy(rng.randn(6, 16).astype(np.float32)).to(BF16)
    h2[:, 2] = h2[:, 2].abs() + 0.5   # every row meets the weight: +inf
    w_t = rng.randn(16, 40).astype(np.float32)
    w_t[2, 7] = np.inf
    b = np.zeros(40, np.float32)
    args = (h2.float(), torch.from_numpy(w_t), torch.from_numpy(b), 5)
    f32 = vt.vocab_topk_lse_plain(*args)
    planes = vt.vocab_planes_plain(*args)
    want = [np.asarray(a) for a in vocab_topk_lse_xla(
        jnp.asarray(args[0].numpy()), jnp.asarray(w_t), jnp.asarray(b), 5)]
    np.testing.assert_array_equal(f32[2].numpy(), want[2])
    assert np.isinf(want[2]).all() and torch.isnan(planes[2]).all()
    # the logit of column 7 alone: +inf in f32, NaN on the planes (on the
    # card the NaN ranks first; the CPU's 0 x inf is a sign-set NaN, last)
    logits = vt.vocab_planes_plain(args[0], args[1][:, 7:8], args[2][7:8], 1)
    assert torch.isnan(logits[0]).all()
    # an infinite h2 entry: W_t's zero planes (an entry exact in bf16)
    h2 = torch.zeros((1, 16))
    h2[0, 4] = np.inf
    w = torch.from_numpy(w_t).clone()
    w[2, 7] = 1.0
    w[4] = torch.where(torch.arange(40) % 2 == 0, 0.5, w[4])
    got = vt.vocab_planes_plain(h2, w, torch.zeros(40), 5)
    assert torch.isnan(got[2]).all()
    assert torch.isinf(vt.vocab_topk_lse_plain(h2, w, torch.zeros(40),
                                               5)[2]).all()


@pytest.mark.parametrize("v", [30, 29, 10000])
@pytest.mark.parametrize("table", [None, BF16])
def test_facade_pads_its_tables_once(v, table):
    """The facade's out_fc table: rows V8 = V rounded up to 8 apart from a
    16-byte-aligned base, zero past V, equal to the decode params' W_t; an
    f32 table's planes beside it (W_t's split, made once); the same
    objects on every later call."""
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    cfg = CaptionerConfig(seq_len=4, vocab_size=v, bos_idx=2,
                          det_feat_size=8, input_encoding_size=8,
                          rnn_size=8, att_size=8)
    cap = ControllableCaptioner(
        cfg, params=init_captioner_params(torch.Generator().manual_seed(0),
                                          cfg),
        use_fused_attention=True, use_vocab_topk=True, table_dtype=table,
        device="cpu")
    fn, (w_t, bias) = cap._vocab_fn_and_tables(5)
    v8 = v + -v % 8
    assert w_t.shape == (8, v) and w_t.stride() == (v8, 1)
    assert w_t.data_ptr() % 16 == 0 and w_t.dtype == (table or F32)
    full = w_t.as_strided((8, v8), (v8, 1))
    assert not full[:, v:].any()
    assert torch.equal(w_t, cap.decode_params["out_fc"]["weight"].T.to(
        table or F32))
    if table is None:
        assert torch.equal(cap._w_planes.view(torch.int16),
                           vt.split_bf16x3_plain(w_t).view(torch.int16))
        assert fn.keywords["w_planes"] is cap._w_planes
    else:
        assert cap._w_planes is None and "w_planes" not in fn.keywords
    again = cap._vocab_fn_and_tables(5)[1]
    assert again[0] is w_t and again[1] is bias


def test_fast_beam_at_a_ragged_vocab_matches_jax():
    """A CPU beam at V 29 (no multiple of 8) through the padded f32 table
    gives the tokens of JAX's beam on its vocab kernel (in interpret mode,
    its table padded once too), at tests/test_torch_beam.py's bar."""
    from vsrcic_tpu.models.api import ControllableCaptioner as JaxCaptioner
    from vsrcic_tpu.models.captioner import (
        CaptionerConfig as JaxConfig, init_captioner_params as jax_init)
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    from vsrcic_tpu_torch.utils.params import params_from_jax
    kw = dict(seq_len=tp.T, vocab_size=29, bos_idx=tp.BOS, det_feat_size=tp.D,
              input_encoding_size=tp.E, rnn_size=tp.R, att_size=tp.A)
    params = tp.to_numpy_tree(jax_init(jax.random.PRNGKey(4),
                                       JaxConfig(**kw)))
    det, groups, verb_list = tp.inputs(1)
    want = JaxCaptioner(JaxConfig(**kw), params=params,
                        verb_2_vob_all=tp.VERB_TABLE, use_vocab_topk=True,
                        pallas_interpret=True).beam_search_v(
        det, groups, verb_list, eos_word=tp.EOS, beam_size=5)
    cap = ControllableCaptioner(
        CaptionerConfig(**kw), params=params_from_jax(params, "cpu"),
        verb_2_vob_all=tp.VERB_TABLE, use_vocab_topk=True, device="cpu")
    got = cap.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                            beam_size=5)
    assert cap._vocab_tables[0].stride(0) == 32
    tp.assert_beams_match(got, want)


# (name, rows, R, V, k, h2 dtype, table dtype, W_t aligned, W_t's rows
# apart (None: V), route, cluster)
ROUTES = [
    ("f32_table", *BEAM, F32, F32, True, None, "split9", 2),
    ("bf16_h2_f32_table", *BEAM, BF16, F32, True, None, "split_w", 2),
    ("bf16_h2_f32_table_ragged_r", 37, 1001, 1000, 5, BF16, F32, True, None,
     "split9", 2),
    ("f32_table_padded_v", 64, 1000, 9999, 5, F32, F32, True, 10000,
     "split9", 2),
    ("bf16_table_padded_v", 64, 1000, 9999, 5, F32, BF16, True, 10000,
     "split", 2),
    ("bf16_operands_padded_v", 64, 1000, 9999, 5, BF16, BF16, True, 10000,
     "tma", 2),
    ("cli_v30_padded", 2560, 1000, 30, 5, F32, BF16, True, 32, "split", 1),
    ("cli_v30_f32_padded", 2560, 1000, 30, 5, F32, F32, True, 32, "split9",
     1),
    ("cli_v30_bf16_h2_f32", 2560, 1000, 30, 5, BF16, F32, True, 32,
     "split_w", 2),
    ("one_tile", 300, 64, 128, 5, F32, F32, True, None, "split9", 1),
    ("two_tiles", 300, 64, 129, 5, F32, F32, True, 136, "split9", 2),
    ("f32_unpadded", 64, 1000, 9999, 5, F32, F32, True, None, "sgemm", 1),
    ("f32_unaligned", *BEAM, F32, F32, False, None, "sgemm", 1),
    ("bf16_h2_f32_unaligned", *BEAM, BF16, F32, False, None, "sgemm", 1),
    ("bf16_table_unpadded", 37, 77, 1001, 5, F32, BF16, True, None,
     "sgemm", 1),
    ("bf16_operands_unpadded", 37, 64, 1001, 5, BF16, BF16, True, None,
     "mma_sync", 1),
]


@pytest.mark.parametrize("case", ROUTES, ids=[c[0] for c in ROUTES])
def test_route_plan(case):
    """Each operand pair and layout on its route: the split routes wherever
    TMA can read W_t (its rows a multiple of 8 apart, its base aligned),
    "sgemm" only where it cannot; clusters of one along the vocab at V <=
    128; every (row block, vocab tile) walked once."""
    _, rows, r, v, k, lhs, table, aligned, ldw, route, cluster = case
    plan = vt.vocab_launch_plan(rows, r, v, k, lhs, table, aligned, 132,
                                ldw=ldw)
    assert (plan.route, plan.cluster) == (route, cluster)
    if route in vt.PLANES:
        assert (plan.planes, plan.w_planes) == vt.PLANES[route]
        assert plan.grid <= 132 and plan.grid % plan.cluster == 0
        assert plan.smem_bytes <= vt.SMEM_MAX
    walk = vt.tile_walk(plan, rows, v)
    seen = sorted(t for cta in walk for t in cta)
    assert seen == [(rb, c) for rb in range(math.ceil(rows / 128))
                    for c in range(math.ceil(v / plan.tile_n))]


def test_plan_refuses_rows_closer_than_v():
    with pytest.raises(ValueError):
        vt.vocab_launch_plan(64, 1000, 9999, 5, F32, F32, True, 132,
                             ldw=9998)


@pytest.mark.parametrize("route,stages", [("split9", 2), ("split_w", 2),
                                          ("split_w", 3)])
def test_plane_rings_fit_and_match_the_source(route, stages):
    """The split routes' rings (the sweep's depths too): stages of every
    plane's boxes of both operands, the shared bytes the source computes
    (tma_smem_bytes), within the card's; "split9"'s six 16 KB boxes a
    stage fit two slots and no third; 128-column tiles."""
    src = (Path(vt.__file__).resolve().parent.parent / "csrc"
           / "vocab_topk.cu").read_text()
    for name, value in (("T_PLANES", vt.SPLIT_PLANES),
                        ("T_BN_SPLIT", vt.SPLIT_TILE_V),
                        ("T_MAX_STAGES", vt.TMA_MAX_STAGES),
                        ("T_BK", vt.TMA_DEPTH), ("T_CLUSTER", vt.TMA_CLUSTER)):
        assert int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1)) == value
    assert "pa * T_A_BYTES + pb * (tma_tile_n(pa, pb) / 64) * T_B_BOX" in src
    planes, w_planes = vt.PLANES[route]
    plan = vt._split_plan(*BEAM, True, 132, stages=stages, route=route)
    stage = 2 * 64 * (planes * 128 + w_planes * 128)
    assert plan.tile_n == 128 and (plan.planes, plan.w_planes) == (
        planes, w_planes)
    assert plan.smem_bytes == 1024 + stages * (stage + 16) <= vt.SMEM_MAX
    default = vt.vocab_launch_plan(*BEAM, F32 if planes == 3 else BF16, F32,
                                   True, 132)
    assert default.stages == (vt.SPLIT9_STAGES if route == "split9"
                              else vt.SPLIT_STAGES)
    with pytest.raises(ValueError):
        vt._split_plan(*BEAM, True, 132, stages=3, route="split9")


@pytest.mark.parametrize("shape", [BEAM, (37, 1001, 1000, 5),
                                   (2560, 1000, 30, 5), (130, 77, 136, 16),
                                   (1, 8, 8, 8), (257, 64, 129, 3)])
@pytest.mark.parametrize("route", ["split9", "split_w"])
@pytest.mark.parametrize("sms", [132, 7, 2])
def test_plane_walks_cover_every_tile_once(shape, route, sms):
    """"split9" clusters along the vocab (two tiles of one row block a
    group, one CTA where V is one tile), "split_w" along the rows (two row
    blocks of one vocab tile, sharing W_t's planes): every (row block,
    vocab tile) once, whole clusters, the CTAs of a cluster on one row
    block ("split9") or one vocab tile ("split_w") at every step."""
    rows, r, v, k = shape
    plan = vt._split_plan(rows, r, v, k, True, sms, ldw=v + -v % 8,
                          route=route)
    assert plan.route == route and plan.grid % plan.cluster == 0
    walk = vt.tile_walk(plan, rows, v)
    seen = [t for cta in walk for t in cta]
    n_rb, n_vt = math.ceil(rows / 128), math.ceil(v / 128)
    assert sorted(seen) == [(rb, c) for rb in range(n_rb)
                            for c in range(n_vt)]
    if plan.cluster == 1:
        assert route == "split9" and n_vt == 1
        return
    for a, b in zip(walk[::2], walk[1::2]):
        if route == "split9":   # tiles past V: only at the end of a walk
            assert [t[0] for t in a][:len(b)] == [t[0] for t in b]
        else:                   # rank 1 takes the row block after rank 0's
            assert all((rb - 1, c) in a for rb, c in b)
