"""The port's vocab top-k + logsumexp against the JAX reference and the JAX
Pallas kernel (interpret mode), on the tie cases of tests/test_vocab_topk.py
(the CUDA kernel is held against its plain version in
tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.vocab_topk import make_vocab_topk_lse, vocab_topk_lse_xla
from vsrcic_tpu_torch.ops.vocab_topk import (vocab_topk_lse,
                                             vocab_topk_lse_plain)

from torch_parity import vocab_case as _case


def _check(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_plain_matches_xla_reference(case):
    h2, w_t, b, k, _ = _case(case)
    want = vocab_topk_lse_xla(jnp.asarray(h2), jnp.asarray(w_t),
                              jnp.asarray(b), k)
    before = vocab_topk_lse.launches
    got = vocab_topk_lse(torch.from_numpy(h2), torch.from_numpy(w_t),
                         torch.from_numpy(b), k)
    assert vocab_topk_lse.launches == before  # CPU: plain version
    _check(got, want)


@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_plain_matches_pallas_interpret(case, two_stage):
    h2, w_t, b, k, kw = _case(case)
    fn = make_vocab_topk_lse(h2.shape[0], h2.shape[1], w_t.shape[1], k,
                             interpret=True, two_stage=two_stage, **kw)
    want = fn(jnp.asarray(h2), jnp.asarray(w_t), jnp.asarray(b))
    got = vocab_topk_lse_plain(torch.from_numpy(h2), torch.from_numpy(w_t),
                               torch.from_numpy(b), k)
    _check(got, want)


def test_plain_bf16_table_matches_pallas_interpret():
    """bf16 weights are upcast and multiplied by the f32 h2 in f32."""
    h2, w_t, b, k, kw = _case("ties")
    fn = make_vocab_topk_lse(h2.shape[0], h2.shape[1], w_t.shape[1], k,
                             interpret=True, two_stage=True,
                             table_dtype=jnp.bfloat16, **kw)
    want = fn(jnp.asarray(h2), jnp.asarray(w_t), jnp.asarray(b))
    got = vocab_topk_lse_plain(torch.from_numpy(h2),
                               torch.from_numpy(w_t).bfloat16(),
                               torch.from_numpy(b), k)
    _check(got, want)


def test_wrapper_refuses_other_devices():
    h2, w_t, b, k, _ = _case("ties")
    meta = lambda x: torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError):
        vocab_topk_lse(meta(h2), meta(w_t), meta(b), k)

