"""The port's eval CLI against the JAX one on the synthetic Flickr world:
test_torch_eval_cli.py's parity cases (every --det / --gt combination and
the fast flags), in a file of their own so that the two worlds' JAX runs
go to two test workers."""
import pytest

import test_torch_eval_cli as base
import torch_parity as tp

DATASET = "flickr"

golden = base.golden
flags = base.flags


@pytest.mark.parametrize("mode", list(tp.EVAL_CLI_MODES))
def test_eval_cli_matches_jax_flickr(mode, flags, golden, tmp_path):
    want = base.check_against_jax(flags[DATASET] + tp.EVAL_CLI_MODES[mode],
                                  tmp_path)
    if mode == "plain":
        assert want == tp.golden_eval_cli_result(golden, DATASET, "strict"), \
            "stale fixture: python tests/torch_parity.py --eval-cli"


def test_eval_cli_fast_flags_match_jax_kernels_flickr(flags, golden,
                                                      tmp_path, monkeypatch):
    want = base.check_against_jax(flags[DATASET] + tp.EVAL_CLI_FAST,
                                  tmp_path, monkeypatch)
    assert want == tp.golden_eval_cli_result(golden, DATASET, "fast"), \
        "stale fixture: python tests/torch_parity.py --eval-cli"
