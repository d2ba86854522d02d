"""The port's vocab top-k + logsumexp on non-finite logits against JAX's
reference (`vocab_topk_lse_xla`): NaN ranks above +inf, a sign-set NaN below
-inf, +0 above -0 (`jax.lax.top_k` on XLA's total-order key), and the
logsumexp follows `jax.nn.logsumexp` (NaN if any value is NaN, else +inf if
any is +inf, -inf on an all -inf row).

bf16 operands: the kernels multiply the bf16 values exactly in f32, so JAX
is given the same values upcast to f32. torch's CPU cast to bf16 turns every
NaN into a sign-set one (0xffff), so there the NaN cases rank their NaNs
last, in both packages. The CUDA kernels are held to the
plain version on these cases in tests/test_torch_kernels_cuda.py.

The captioner facade reads once whether its out_fc table is finite, and
on a non-finite one passes `finite_table=False` on every call: an f32 h2
then takes the f32 SGEMM, not a route that splits h2 into bf16 planes
(whose zero planes meet an infinite weight, 0 x inf = NaN). Here: the flag
and the tables made once, and a beam on a table with an infinite weight
against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vsrcic_tpu.ops.vocab_topk import vocab_topk_lse_xla
from vsrcic_tpu_torch.models import api
from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                               init_captioner_params)
from vsrcic_tpu_torch.ops.vocab_topk import vocab_topk_lse

ROWS, R, V, K = 6, 16, 300, 5


def nonfinite_case(name):
    """(h2, w_t, bias) as f32 numpy, seeded; each case puts its non-finite
    values into a few rows or columns of random inputs."""
    rng = np.random.RandomState(7)
    h2 = rng.randn(ROWS, R).astype(np.float32)
    w_t = rng.randn(R, V).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    if name == "nan_row":          # every logit of row 2 NaN
        h2[2, 4] = np.nan
    elif name == "nan_column":     # column 7 NaN in every row
        w_t[3, 7] = np.nan
    elif name == "inf_products":   # row 1: +inf or -inf by the weight's sign
        h2[1] = 0.0
        h2[1, 3] = np.inf
    elif name == "inf_bias":       # column 11 +inf in every row
        b[11] = np.inf
    elif name == "neg_inf_row":    # every logit of row 4 -inf
        h2[4] = 0.0
        h2[4, 5] = -np.inf
        w_t[5] = np.abs(w_t[5]) + 0.5
    elif name == "signed_zeros":   # row 0: -0 at 20 and 23, +0 at 21 and 22
        h2[0] = 1e-30              # products underflow, keeping their sign
        w_t[:, 20] = w_t[:, 23] = -1e-30
        w_t[:, 21] = w_t[:, 22] = 1e-30
        b[:] = -5.0
        b[20:24] = -0.0
    elif name == "neg_nan":        # column 13 a sign-set NaN: ranks last
        b[13] = -np.nan
        b[40] = np.nan
    else:
        raise ValueError(name)
    return h2, w_t, b


CASES = ["nan_row", "nan_column", "inf_products", "inf_bias", "neg_inf_row",
         "signed_zeros", "neg_nan"]


def _same(got, want):
    """Equal NaN and infinite positions, equal signs; finite values within
    1e-6 relative (the two logsumexps sum in their own orders)."""
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    real = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), ~real)
    np.testing.assert_array_equal(np.signbit(got[real]),
                                  np.signbit(want[real]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_on_nonfinite_logits(case, dtype):
    h2, w_t, b = nonfinite_case(case)
    th2 = torch.from_numpy(h2).to(dtype)
    tw = torch.from_numpy(w_t).to(dtype)
    with np.errstate(invalid="ignore"):
        want = vocab_topk_lse_xla(jnp.asarray(th2.float().numpy()),
                                  jnp.asarray(tw.float().numpy()),
                                  jnp.asarray(b), K)
    before = vocab_topk_lse.launches
    got = vocab_topk_lse(th2, tw, torch.from_numpy(b), K)
    assert vocab_topk_lse.launches == before   # CPU: the plain version
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32 and int(got[1].max()) < V
    _same(got[0], want[0])
    _same(got[2], want[2])
    if dtype == torch.bfloat16 and "nan" in case:
        return   # torch's CPU cast to bf16 sets a NaN's sign: it ranks last
    if case == "nan_row":
        assert got[1][2].tolist() == list(range(K))
        assert torch.isnan(got[2][2]).all()
    elif case in ("nan_column", "inf_bias"):
        assert (got[1][:, 0] == (7 if case == "nan_column" else 11)).all()
    elif case == "inf_products":
        assert float(got[2][1]) == np.inf
    elif case == "neg_inf_row":
        assert got[1][4].tolist() == list(range(K))
        assert float(got[2][4]) == -np.inf
    elif case == "signed_zeros":
        assert got[1][0, :4].tolist() == [21, 22, 20, 23]
    elif case == "neg_nan":
        assert not (got[1] == 13).any() and (got[1][:, 0] == 40).all()


@pytest.mark.parametrize("table", [None, torch.bfloat16])
@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan, None])
def test_facade_reads_whether_its_table_is_finite(value, table, monkeypatch,
                                                  capsys):
    """An out_fc weight of +inf, -inf or NaN marks the captioner's table
    non-finite, a finite one finite; a non-finite table's vocab function
    passes finite_table=False on every call. The table is padded once, its
    check taken with it, and an f32 table's planes made once for the
    routes that read them: a finite f32 table's at once, a non-finite
    one's only under VSRCIC_VOCAB_LHS_BF16=1 ("split_w", which keeps h2 as
    one plane)."""
    made = {"padded_table": 0, "table_planes": 0}
    for name in made:
        def counted(*a, _f=getattr(api, name), _n=name, **kw):
            made[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(api, name, counted)
    monkeypatch.delenv("VSRCIC_VOCAB_LHS_BF16", raising=False)
    cfg = CaptionerConfig(seq_len=4, vocab_size=30, bos_idx=2,
                          det_feat_size=8, input_encoding_size=8,
                          rnn_size=8, att_size=8)
    params = init_captioner_params(torch.Generator().manual_seed(0), cfg)
    if value is not None:
        params["out_fc"]["weight"][11, 3] = value   # W_t[3, 11]
    cap = api.ControllableCaptioner(cfg, params=params, use_vocab_topk=True,
                                    table_dtype=table, device="cpu")
    finite = value is None
    fn, tables = cap._vocab_fn_and_tables(5)
    fn2, tables2 = cap._vocab_fn_and_tables(5)
    assert cap._finite_table is finite
    assert tables2[0] is tables[0] and tables2[1] is tables[1]
    for f in (fn, fn2):   # the op's default, True, where it is finite
        assert f.keywords.get("finite_table", True) is finite
        assert ("w_planes" in f.keywords) == (finite and table is None)
    planes = int(finite and table is None)
    assert made == {"padded_table": 1, "table_planes": planes}
    assert ("non-finite" in capsys.readouterr().err) == (not finite)
    monkeypatch.setenv("VSRCIC_VOCAB_LHS_BF16", "1")
    fn3, tables3 = cap._vocab_fn_and_tables(5)
    assert tables3[0] is tables[0]
    assert made == {"padded_table": 1, "table_planes": int(table is None)}
    # on the CPU both calls are the plain version, the flag unread
    h2 = torch.from_numpy(np.random.RandomState(0).randn(7, 8).astype(
        np.float32))
    for f, lhs in ((fn, h2), (fn3, h2.bfloat16())):
        for a, b in zip(f(h2, *tables),
                        api.vocab_topk_lse_plain(lhs, *tables, 5)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_facade_beam_on_an_infinite_weight_matches_jax():
    """The port's beam with its vocab op (the plain version on the CPU, the
    table marked non-finite) on a table with a -inf weight that meets an h2
    entry > 0 at every step, against JAX's beam on its XLA vocab top-k (the
    f32 product): the same words and gates, scores and logprobs at
    tests/test_torch_beam.py's bar, NaN where JAX has NaN; the -inf word
    never emitted."""
    from vsrcic_tpu.models.api import ControllableCaptioner as JaxCaptioner
    from vsrcic_tpu.models.captioner import (
        CaptionerConfig as JaxConfig, init_captioner_params as jax_init)
    from vsrcic_tpu_torch.utils.params import params_from_jax
    kw = dict(seq_len=tp.T, vocab_size=tp.V, bos_idx=tp.BOS,
              det_feat_size=tp.D, input_encoding_size=tp.E, rnn_size=tp.R,
              att_size=tp.A)
    params = tp.infinite_weight(jax.tree_util.tree_map(
        np.array, jax_init(jax.random.PRNGKey(4), JaxConfig(**kw))), tp.R)
    det, groups, verb_list = tp.inputs(1)
    want = JaxCaptioner(JaxConfig(**kw), params=params,
                        verb_2_vob_all=tp.VERB_TABLE,
                        use_vocab_topk="xla").beam_search_v(
        det, groups, verb_list, eos_word=tp.EOS, beam_size=5)
    cap = api.ControllableCaptioner(
        CaptionerConfig(**kw), params=params_from_jax(params, "cpu"),
        verb_2_vob_all=tp.VERB_TABLE, use_vocab_topk=True, device="cpu")
    got = cap.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                            beam_size=5)
    assert cap._finite_table is False
    tp.assert_beams_match(got, want)
    assert not (np.asarray(want.words) == 20).any()
