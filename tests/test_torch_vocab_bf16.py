"""The vocab head's bf16-operand configuration (JAX's
`make_vocab_topk_lse(lhs_dtype=bfloat16)`, VSRCIC_VOCAB_LHS_BF16=1): the
port's plain version on a bf16 h2 against the JAX Pallas kernel in
interpret mode, the wrapper's dtype routing on the CPU, and the facade's
`beam_search_v` under the variable against JAX's (the tensor-core kernel
is held against its plain version in tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.vocab_topk import make_vocab_topk_lse
from vsrcic_tpu_torch.ops.vocab_topk import (vocab_topk_lse,
                                             vocab_topk_lse_plain)
from vsrcic_tpu_torch.tools.golden_bf16 import LHS_BF16

import torch_parity as tp

TABLES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_plain_bf16_lhs_matches_pallas_interpret(case, two_stage, table):
    """JAX casts h2 to bf16 outside the kernel; the port's op rounds it
    the same way and the plain version multiplies the exact upcasts in f32.
    Ids exact, values and lse within rtol 1e-5."""
    h2, w_t, b, k, kw = tp.vocab_case(case)
    jdt, tdt = TABLES[table]
    fn = make_vocab_topk_lse(h2.shape[0], h2.shape[1], w_t.shape[1], k,
                             interpret=True, two_stage=two_stage,
                             table_dtype=jdt, lhs_dtype=jnp.bfloat16, **kw)
    want = fn(jnp.asarray(h2), jnp.asarray(w_t), jnp.asarray(b))
    got = vocab_topk_lse_plain(torch.from_numpy(h2).bfloat16(),
                               torch.from_numpy(w_t).to(tdt),
                               torch.from_numpy(b), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_wrapper_runs_plain_for_bf16_on_cpu():
    h2, w_t, b, k, _ = tp.vocab_case("ties")
    args = (torch.from_numpy(h2).bfloat16(),
            torch.from_numpy(w_t).bfloat16(), torch.from_numpy(b))
    before = (vocab_topk_lse.launches, vocab_topk_lse.launches_bf16)
    got = vocab_topk_lse(*args, k)
    assert (vocab_topk_lse.launches,
            vocab_topk_lse.launches_bf16) == before
    for g, w in zip(got, vocab_topk_lse_plain(*args, k)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("h2_dtype, w_dtype", [
    (torch.float16, torch.bfloat16), (torch.float64, torch.float32),
    (torch.bfloat16, torch.float16), (torch.float32, torch.float64)])
def test_wrapper_refuses_other_dtypes(h2_dtype, w_dtype):
    h2, w_t, b, k, _ = tp.vocab_case("ties")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        vocab_topk_lse(torch.from_numpy(h2).to(h2_dtype),
                       torch.from_numpy(w_t).to(w_dtype),
                       torch.from_numpy(b), k)


@pytest.fixture(scope="module")
def lhs_bf16_captioners():
    """(JAX, port) fast captioner pairs per table dtype, built and run
    under VSRCIC_VOCAB_LHS_BF16=1 (JAX reads it when it traces)."""
    params = tp.to_numpy_tree(tp.jax_params())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(LHS_BF16, "1")
        yield {t: (tp.jax_captioner(params, t),
                   tp.torch_captioner(params, t)) for t in ("f32", "bf16")}


@pytest.mark.parametrize("gt", [False, True])
@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_fast_beam_under_lhs_bf16_matches_jax(lhs_bf16_captioners, table,
                                              seed, gt):
    jc, tc = lhs_bf16_captioners[table]
    det, groups, verb_list = tp.inputs(seed, gt)
    want = jc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                            beam_size=5, gt=gt)
    got = tc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                           beam_size=5, gt=gt)
    # bf16 h2 makes 1-ulp ties of two beams' candidates (seed 2, step 7):
    # their records may be exchanged (the helper's note)
    tp.assert_beams_match_save_tied(got, want)


def test_the_variable_is_read_per_beam(monkeypatch):
    """The port reads the variable whenever a beam builds its vocab op:
    on, the op receives a bf16 h2 and the beam's logprobs move; "plain"
    (JAX's "xla" path) ignores it."""
    params = tp.to_numpy_tree(tp.jax_params())
    det, groups, verb_list = tp.inputs(2)
    seen = []

    def spy(h2, w_t, bias, k):
        seen.append(h2.dtype)
        return vocab_topk_lse_plain(h2, w_t, bias, k)
    from vsrcic_tpu_torch.models import api
    monkeypatch.setattr(api, "vocab_topk_lse", spy)
    runs = {}
    for mode in (True, "plain"):
        cap = tp.torch_captioner(params, "bf16")
        cap.use_vocab_topk = mode
        for on in ("0", "1"):
            monkeypatch.setenv(LHS_BF16, on)
            seen.clear()
            runs[mode, on] = tp.result_arrays(cap.beam_search_v(
                det, groups, verb_list, eos_word=tp.EOS, beam_size=5))
            want = ([] if mode == "plain" else
                    [torch.bfloat16 if on == "1" else torch.float32] * tp.T)
            assert seen == want
    assert not np.array_equal(runs[True, "0"]["word_logps"],
                              runs[True, "1"]["word_logps"])
    for f in tp.RESULT_FIELDS:
        assert np.array_equal(runs["plain", "0"][f], runs["plain", "1"][f])
        assert np.array_equal(runs["plain", "0"][f], runs[True, "0"][f])
