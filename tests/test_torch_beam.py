"""The ported slice as a whole, strict path: the port's
`ControllableCaptioner.beam_search_v` / `beam_search` against the JAX
package's on the inputs of tests/test_vocab_topk.py, and the golden fixture
that ties the card's replay (chip_smoke.py) to JAX."""
import numpy as np
import pytest
import torch

import torch_parity as tp


@pytest.fixture(scope="module")
def params():
    return tp.to_numpy_tree(tp.jax_params())


@pytest.fixture(scope="module")
def strict(params):
    """One (JAX, port) strict captioner pair for the module, so JAX
    compiles each (beam, gt) program once, not once per seed."""
    return tp.jax_captioner(params), tp.torch_captioner(params)


@pytest.mark.parametrize("gt", [False, True])
@pytest.mark.parametrize("seed", [2, 7])
def test_strict_beam_search_v_matches_jax(strict, seed, gt):
    jc, tc = strict
    det, groups, verb_list = tp.inputs(seed, gt)
    for beam in (3, 5):
        want = jc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                                beam_size=beam, gt=gt)
        got = tc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                               beam_size=beam, gt=gt)
        tp.assert_beams_match(got, want)


@pytest.mark.parametrize("fast", [None, "f32"])
def test_beam_search_matches_jax(params, fast):
    """beam_search (no verb substitution) on the dense joint beam."""
    jc, tc = tp.jax_captioner(params, fast), tp.torch_captioner(params, fast)
    det, groups, _ = tp.inputs(7)
    want = jc.beam_search(det, groups, eos_word=tp.EOS, beam_size=3)
    got = tc.beam_search(det, groups, eos_word=tp.EOS, beam_size=3)
    tp.assert_beams_match(got, want)


def test_facade_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.torch_captioner(tp.to_numpy_tree(tp.jax_params()), device=None)


def test_golden_fixture_is_current():
    """Regenerating the fixture from JAX gives the committed arrays
    (rewrite it with `python tests/torch_parity.py`): inputs, parameters,
    words and gates exactly; logprobs and scores to 1e-6 relative, so that
    a CPU with other vector units still counts as current."""
    want = tp.golden_arrays()
    with np.load(tp.GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            if k.endswith(("logps", "scores")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", ["strict", "fast_bf16"])
def test_golden_fixture_replays_on_cpu(path):
    """The replay chip_smoke.py makes on the card, here through the plain
    versions of the kernels."""
    from vsrcic_tpu_torch.utils.params import unflatten
    with np.load(tp.GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    params = unflatten({k[len("param/"):]: v for k, v in g.items()
                        if k.startswith("param/")})
    tc = tp.torch_captioner(params, None if path == "strict" else "bf16")
    got = tp.result_arrays(tc.beam_search_v(
        g["detections"], g["det_groups"], g["verb_list"],
        eos_word=int(g["eos_word"]), beam_size=int(g["beam_size"])))
    for f in ("words", "gates"):
        np.testing.assert_array_equal(got[f], g[path + "/" + f])
    for f in ("scores", "word_logps", "gate_logps"):
        np.testing.assert_allclose(got[f], g[path + "/" + f], rtol=1e-5,
                                   atol=1e-6)
