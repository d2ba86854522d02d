"""The port's eval CLI at `--data_parallel 2 --platform cpu`: two gloo
ranks on the CPU, every rank reading every batch and decoding its block,
rank 0 alone printing, dumping and scoring. From the golden fixture's
checkpoints (vsrcic_tpu_torch/testdata/golden_eval_cli.npz) it dumps the
`--data_parallel 0` run's captions in the same order and prints the same
metric lines and CIDEr, which are the JAX CLI's (the fixture's).
"""
import pytest

from vsrcic_tpu_torch.cli import eval as torch_eval
from vsrcic_tpu_torch.tools.eval_checkpoints import golden_flags, load_golden

import torch_parity as tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    golden = load_golden()
    root = tmp_path_factory.mktemp("parallel_eval_cli")
    argv = golden_flags(golden, "coco", str(root)) + ["--platform", "cpu"]
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")      # the spawned ranks' threads
    try:
        return {dp: tp.run_eval_cli(torch_eval.main,
                                    argv + ["--data_parallel", dp],
                                    root / ("dp%s.jsonl" % dp))
                for dp in ("0", "2")}, tp.golden_eval_cli_result(
                    golden, "coco", "strict")
    finally:
        mp.undo()


def test_data_parallel_dump_is_the_single_device_dump(runs):
    res, golden = runs
    assert res["2"]["n"] == res["0"]["n"] == golden["n"] == 8
    assert res["2"]["dump"].splitlines() == res["0"]["dump"].splitlines()
    assert res["2"]["dump"].splitlines() == golden["dump"].splitlines()


def test_data_parallel_metric_lines_are_the_single_device_ones(runs):
    res, golden = runs
    assert res["2"]["metrics"] == res["0"]["metrics"] == golden["metrics"]
    assert res["2"]["cider"] == res["0"]["cider"] == golden["cider"]
