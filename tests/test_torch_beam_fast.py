"""The ported slice as a whole, fast path: the port's `beam_search_v` with
fused attention, vocab top-k and f32 or bf16 tables (the kernels' plain
versions on the CPU) against JAX's fast path with the Pallas kernels in
interpret mode."""
import pytest

import torch_parity as tp


@pytest.fixture(scope="module")
def captioners():
    """One (JAX, port) captioner pair per table dtype for the module, so
    JAX compiles each (beam, gt) program once, not once per seed."""
    params = tp.to_numpy_tree(tp.jax_params())
    return {t: (tp.jax_captioner(params, t), tp.torch_captioner(params, t))
            for t in ("f32", "bf16")}


@pytest.mark.parametrize("gt", [False, True])
@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_fast_beam_search_v_matches_jax(captioners, table, seed, gt):
    jc, tc = captioners[table]
    det, groups, verb_list = tp.inputs(seed, gt)
    for beam in (3, 5):
        want = jc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                                beam_size=beam, gt=gt)
        got = tc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                               beam_size=beam, gt=gt)
        tp.assert_beams_match(got, want)

