"""The port's vocab top-k + logsumexp on non-finite logits against JAX's
reference (`vocab_topk_lse_xla`): NaN ranks above +inf, a sign-set NaN below
-inf, +0 above -0 (`jax.lax.top_k` on XLA's total-order key), and the
logsumexp follows `jax.nn.logsumexp` (NaN if any value is NaN, else +inf if
any is +inf, -inf on an all -inf row).

bf16 operands: the kernels multiply the bf16 values exactly in f32, so JAX
is given the same values upcast to f32. torch's CPU cast to bf16 turns every
NaN into a sign-set one (0xffff), so there the NaN cases rank their NaNs
last, in both packages. The CUDA kernels are held to the
plain version on these cases in tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.vocab_topk import vocab_topk_lse_xla
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
