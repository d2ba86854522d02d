"""The port's captioner train CLI at `--data_parallel 2 --platform cpu` (two
gloo ranks on the CPU) against its `--data_parallel 0` run: XE as the train
CLIs' golden fixture runs it (vsrcic_tpu_torch/tools/train_cli_golden.py:
tiny widths, three steps over two epochs from a JAX-made checkpoint), each
rank stepping on half of each batch of 8. Every per-step loss of the
journal, which rank 0 alone writes, is within rtol 1e-4 of the
single-device run's, the validation lines are equal and the saved weights
agree (`check_weights`). SCST's run is in test_torch_parallel_scst_cli.py,
the planner CLIs' in test_torch_parallel_planner_cli.py.
"""
import os
import shutil

import numpy as np
import pytest

from vsrcic_tpu_torch.cli import train as torch_train
from vsrcic_tpu_torch.core.checkpoint import _flatten, _load_npz
from vsrcic_tpu_torch.tools import train_cli_golden as g


def run_both(tmp, main, argv_at, saved, prepare=None):
    """{dp: (run_captured's result, the saved weights)} of main at
    --data_parallel 0 and 2 on the CPU, each under its own root:
    argv_at(root) gives the flags, prepare(root) writes what the run reads
    first, `saved` is the checkpoint it writes (under the root)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")      # the spawned ranks' threads
    out = {}
    try:
        for dp in ("0", "2"):
            root = str(tmp / ("dp" + dp))
            if prepare is not None:
                prepare(root)
            res = g.run_captured(main, argv_at(root) + [
                "--platform", "cpu", "--data_parallel", dp])
            out[dp] = res, {k: v for k, v in _flatten(_load_npz(
                os.path.join(root, saved))).items()
                if k.startswith("params/")}
    finally:
        mp.undo()
    return out


def check_weights(got, want, lr, steps):
    """The saved weights within rtol 1e-4 / atol 1e-6 of the single-device
    run's for at least 99% of their entries, and every entry within 2 lr a
    step: where a gradient is round-off of zero, Adam's normalisation turns
    the two runs' different sums of it into steps of up to lr
    (test_torch_parallel_planners.py shows which), so those entries are
    bounded by the optimiser, not by the gradient."""
    assert sorted(got) == sorted(want)
    close = [np.isclose(got[k], w, **g.PARAM_TOL).ravel()
             for k, w in want.items()]
    assert np.concatenate(close).mean() >= 0.99
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * lr * steps,
                                   err_msg=k)


def check_runs(runs, lr):
    (got, got_params), (want, want_params) = runs["2"], runs["0"]
    assert got["steps"] == want["steps"] and len(want["steps"]) >= 2
    assert all(np.isfinite(want["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=g.LOSS_RTOL, atol=0)
    assert g.lines_match(got["lines"], want["lines"]), (got["lines"],
                                                       want["lines"])
    check_weights(got_params, want_params, lr, len(want["steps"]))
    assert any(ln.startswith("data parallel: gloo, ranks 0:cpu, 1:cpu")
               for ln in got["out"])
    return got


def test_xe_data_parallel_is_the_single_device_run(tmp_path):
    golden = g.load_golden()
    runs = run_both(tmp_path, torch_train.main,
                    lambda root: g.golden_flags(golden, "xe", root),
                    g.RUNS["xe"][2])
    got = check_runs(runs, lr=5e-4)
    assert sum(" val CIDEr " in ln for ln in got["lines"]) == 2


def test_xe_needs_a_batch_that_divides(tmp_path):
    """XE steps on the ranks' equal blocks: a batch that does not divide by
    --data_parallel is refused when the flags are parsed, as in JAX."""
    with pytest.raises(SystemExit):
        torch_train.main(["--dataset", "coco", "--checkpoint_path",
                          str(tmp_path), "--batch_size", "7", "--platform",
                          "cpu", "--data_parallel", "2"])
    shutil.rmtree(tmp_path, ignore_errors=True)
