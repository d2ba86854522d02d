"""The facade's decode_dtype against JAX's: `test`, `beam_search` and
`beam_search_v` with every parameter cast to bf16, strict and with both
kernels' plain versions (JAX: the Pallas kernels in interpret mode); what
decode_dtype leaves alone; and the replay of the bf16 modes' golden
fixture (testdata/golden_beam_bf16.npz) through the plain versions."""
import numpy as np
import pytest
import torch

from vsrcic_tpu_torch.tools import golden_bf16 as gb
from vsrcic_tpu_torch.utils.params import flatten

import torch_parity as tp

MODES = {"strict": None, "fast": "f32"}


@pytest.fixture(scope="module")
def params():
    return tp.to_numpy_tree(tp.jax_params())


@pytest.fixture(scope="module")
def captioners(params):
    """One (JAX, port) pair per mode with decode_dtype=bfloat16 and no
    table_dtype (the tables then take the decode dtype)."""
    return {m: (tp.jax_captioner(params, fast, decode_bf16=True),
                tp.torch_captioner(params, fast, decode_bf16=True))
            for m, fast in MODES.items()}


@pytest.mark.parametrize("gt", [False, True])
@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_beam_search_v_matches_jax(captioners, mode, seed, gt):
    jc, tc = captioners[mode]
    det, groups, verb_list = tp.inputs(seed, gt)
    want = jc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                            beam_size=5, gt=gt)
    got = tc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                           beam_size=5, gt=gt)
    tp.assert_beams_match(got, want)


@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_beam_search_matches_jax(captioners, mode, seed):
    jc, tc = captioners[mode]
    det, groups, _ = tp.inputs(seed)
    want = jc.beam_search(det, groups, eos_word=tp.EOS, beam_size=5)
    got = tc.beam_search(det, groups, eos_word=tp.EOS, beam_size=5)
    tp.assert_beams_match(got, want)


@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_greedy_test_matches_jax(captioners, mode, seed):
    jc, tc = captioners[mode]
    det, groups, _ = tp.inputs(seed)
    for got, want in zip(tc.test(det, groups), jc.test(det, groups)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_what_decode_dtype_casts(params):
    """decode_params are the bf16 params; forward and sample_rl keep the
    f32 ones (as in JAX): forward gives what a captioner without
    decode_dtype gives, sample_rl what one with bf16 tables gives (its
    statics take the decode dtype, as JAX's do); the statics and the vocab
    tables take the decode dtype where no table_dtype is given (the vocab
    table in f32, its values bf16-rounded, as JAX's kernel tables)."""
    base = tp.torch_captioner(params, "f32")
    cap = tp.torch_captioner(params, "f32", decode_bf16=True)
    assert all(v.dtype == torch.bfloat16 for v in
               flatten(cap.decode_params).values())
    assert all(v.dtype == torch.float32 for v in
               flatten(cap.params).values())
    det, groups, _ = tp.inputs(2)
    caps = torch.from_numpy(np.random.RandomState(0).randint(
        0, tp.V, (tp.B, tp.T)))
    ctrl = torch.from_numpy(groups[:, :1].repeat(tp.T, 1))
    for got, want in zip(cap.forward(det, caps, ctrl),
                         base.forward(det, caps, ctrl)):
        assert torch.equal(got, want)
    tables = tp.torch_captioner(params, "bf16")
    outs = [c.sample_rl(det, groups, torch.Generator().manual_seed(3))
            for c in (cap, tables)]
    for got, want in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        assert torch.equal(got, want)
    assert cap._cast(torch.ones(2)).dtype == torch.bfloat16
    statics, _, _ = cap._fused_statics(cap.decode_params,
                                       torch.from_numpy(det),
                                       torch.from_numpy(groups))
    assert statics.det_groups.dtype == torch.bfloat16
    assert statics.det_groups_proj.dtype == torch.bfloat16
    _, (w_t, bias) = cap._vocab_fn_and_tables(5)
    assert w_t.dtype == bias.dtype == torch.float32
    assert torch.equal(w_t, cap.decode_params["out_fc"]["weight"].T.float())


@pytest.mark.parametrize("path", list(gb.PATHS))
def test_golden_bf16_fixture_replays_on_cpu(path):
    """The replay chip_smoke.py makes on the card (phase 4), here through
    the plain versions of the kernels: JAX's words and gates exactly,
    scores and logprobs at the beam bar save the records of tied
    candidates (assert_beams_match_save_tied)."""
    g = gb.load()
    want = {f: g[path + "/" + f] for f in tp.RESULT_FIELDS}
    tp.assert_beams_match_save_tied(gb.replay(g, path, "cpu"),
                                    type("R", (), want))
