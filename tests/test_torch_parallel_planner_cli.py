"""The port's planner train CLIs at `--data_parallel 2 --platform cpu` (two
gloo ranks on the CPU) against their `--data_parallel 0` runs, at the tiny
widths of test_torch_train_cli.py, 3 steps each, with group and pair counts
that do not divide by 2: S-SSP (dropout 0.1: each rank takes its rows of
the masks the whole batch draws) and the Sinkhorn planner. Every per-step
loss of rank 0's journal is within rtol 1e-4 of the single-device run's
and the saved weights agree (test_torch_parallel_train_cli.check_weights).
"""
import os

import pytest

from vsrcic_tpu_torch.cli import train_region_sort as torch_region_sort
from vsrcic_tpu_torch.cli import train_sinkhorn as torch_sinkhorn

from test_torch_parallel_train_cli import check_runs, run_both
from test_torch_train_cli import TINY, TINY_SSP

# run -> (CLI, its flags, the checkpoint it saves, its learning rate)
RUNS = {"ssp": (torch_region_sort, TINY_SSP, "coco_s_ssp/model-tr", 1e-4),
        "sinkhorn": (torch_sinkhorn, [], "coco_sinkhorn/model-sh", 1e-4)}


@pytest.mark.parametrize("name", list(RUNS))
def test_data_parallel_is_the_single_device_run(tmp_path, name):
    cli, flags, saved, lr = RUNS[name]
    tiny = [a for a in TINY if a not in ("--platform", "cpu")]

    def argv_at(root):
        return (["--dataset", "coco", "--checkpoint_path", root,
                 "--log_dir", os.path.join(root, "log"),
                 "--max_steps", "3"] + tiny + flags)

    check_runs(run_both(tmp_path, cli.main, argv_at, saved), lr)
