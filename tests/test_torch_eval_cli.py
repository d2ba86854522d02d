"""The port's eval CLI (`vsrcic_tpu_torch.cli.eval`) against the JAX one on
the synthetic COCO world, from the same npz checkpoints (the golden
fixture's, vsrcic_tpu_torch/testdata/golden_eval_cli.npz), with the same
argv on the CPU: the dumped captions, the returned CIDEr and every printed
metric line must be equal. The Flickr world's cases are in
test_torch_eval_cli_flickr.py.

Fast flags: the port's --fused --vocab_topk --bf16_tables run the kernels'
plain versions on the CPU. JAX's CLI on the CPU maps --vocab_topk to its
"xla" candidate path, which reads the f32 out_fc table even under
--bf16_tables, so it is not the function the kernels compute; the JAX side
of that comparison runs its Pallas kernels in interpret mode instead
(torch_parity.jax_pallas_interpret_captioner), and the bar is the fast
path's: ids exact, here the dumped captions.

Also the port's side of tests/test_cli_lifecycle.py's eval checks and the
golden replay (the fixture is what the JAX CLI prints today: the strict
and fast JAX runs below fail while it is stale; rewrite it with
`python tests/torch_parity.py --eval-cli`).
"""
import numpy as np
import pytest
import torch

from vsrcic_tpu.cli import eval as jax_eval
from vsrcic_tpu.models import api as jax_api
from vsrcic_tpu_torch.cli import eval as torch_eval
from vsrcic_tpu_torch.core.checkpoint import _load_npz, _save_npz
from vsrcic_tpu_torch.tools.eval_checkpoints import (golden_flags,
                                                     load_golden)

import torch_parity as tp

DATASET = "coco"


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def flags(golden, tmp_path_factory):
    """The fixture's run flags, its checkpoints written to a temporary
    directory, on the CPU."""
    out = tmp_path_factory.mktemp("ckpt")
    return {ds: golden_flags(golden, ds, str(out)) + ["--platform", "cpu"]
            for ds in ("coco", "flickr")}


def check_against_jax(argv, tmp_path, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(jax_api, "ControllableCaptioner",
                            tp.jax_pallas_interpret_captioner())
    want = tp.run_eval_cli(jax_eval.main, argv, tmp_path / "jax.jsonl")
    got = tp.run_eval_cli(torch_eval.main, argv, tmp_path / "torch.jsonl")
    assert got["dump"].splitlines() == want["dump"].splitlines()
    assert got["n"] == want["n"] == 8
    assert got["metrics"] == want["metrics"]
    assert got["cider"] == want["cider"]
    names = [line.split()[0] for line in got["metrics"]]
    assert names[:6] == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L",
                         "CIDEr"]
    return want


@pytest.mark.parametrize("mode", list(tp.EVAL_CLI_MODES))
def test_eval_cli_matches_jax(mode, flags, golden, tmp_path):
    want = check_against_jax(flags[DATASET] + tp.EVAL_CLI_MODES[mode],
                             tmp_path)
    if mode == "plain":
        assert want == tp.golden_eval_cli_result(golden, DATASET, "strict"), \
            "stale fixture: python tests/torch_parity.py --eval-cli"


def test_eval_cli_fast_flags_match_jax_kernels(flags, golden, tmp_path,
                                               monkeypatch):
    want = check_against_jax(flags[DATASET] + tp.EVAL_CLI_FAST, tmp_path,
                             monkeypatch)
    assert want == tp.golden_eval_cli_result(golden, DATASET, "fast"), \
        "stale fixture: python tests/torch_parity.py --eval-cli"


@pytest.mark.parametrize("dataset", ["coco", "flickr"])
@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_golden_eval_cli_replay(dataset, mode, flags, golden, tmp_path):
    """The port alone, from the fixture: what chip_smoke.py phase 13a
    checks on the card."""
    extra = tp.EVAL_CLI_FAST if mode == "fast" else []
    got = tp.run_eval_cli(torch_eval.main, flags[dataset] + extra,
                          tmp_path / "dump.jsonl")
    assert got == tp.golden_eval_cli_result(golden, dataset, mode)


def test_eval_cli_rebuilds_model_from_ckpt_cfg(flags, tmp_path):
    """No width flags: the CLI's defaults are the full widths (1000/1000/
    512), and the captioner's must come from the checkpoint's cfg block."""
    argv = list(flags[DATASET])
    for f in ("--rnn_size", "--att_size", "--input_encoding_size"):
        i = argv.index(f)
        del argv[i:i + 2]
    got = tp.run_eval_cli(torch_eval.main, argv, tmp_path / "a.jsonl")
    want = tp.run_eval_cli(torch_eval.main, flags[DATASET],
                           tmp_path / "b.jsonl")
    assert got == want


def test_eval_cli_vocab_mismatch_exits(flags, tmp_path):
    argv = list(flags[DATASET])
    path = argv[argv.index("--captioner_ckpt") + 1]
    tree = _load_npz(path)
    tree["cfg"]["vocab_size"] = np.asarray(int(tree["cfg"]["vocab_size"]) + 1)
    bad = str(tmp_path / "bad.npz")
    _save_npz(bad, tree)
    argv[argv.index("--captioner_ckpt") + 1] = bad
    with pytest.raises(SystemExit, match="vocab_size"):
        torch_eval.main(argv)


def test_eval_cli_data_parallel_raises(flags):
    with pytest.raises(NotImplementedError, match="item 7"):
        torch_eval.main(flags[DATASET] + ["--data_parallel", "1"])


def test_eval_cli_wants_the_card(flags):
    """Without --platform cpu the CLI runs on the card, and raises where
    there is none (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a for a in flags[DATASET] if a not in ("--platform", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_eval.main(argv)
