"""The port's SCST train CLI (`--sample_rl`) at `--data_parallel 2
--platform cpu` (two gloo ranks on the CPU) against its `--data_parallel 0`
run: from the train CLIs' golden XE checkpoint as XE's best, at the
fixture's tiny widths, on batches of 7 (the pad path), strict decode, two
steps. The per-step losses of rank 0's journal are within rtol 1e-4 of the
single-device run's (the strict sampled trajectories are the single-device
ones), the validation lines are equal and the saved weights agree
(test_torch_parallel_train_cli.check_weights).
"""
import os

from vsrcic_tpu_torch.cli import train as torch_train
from vsrcic_tpu_torch.core.checkpoint import _save_npz
from vsrcic_tpu_torch.tools import train_cli_golden as g

from test_torch_parallel_train_cli import check_runs, run_both


def test_scst_data_parallel_is_the_single_device_run(tmp_path):
    golden = g.load_golden()

    def prepare(root):
        path = os.path.join(root, "coco_cap", "exp_best.npz")
        os.makedirs(os.path.dirname(path))
        _save_npz(path, g.init_flat(golden, "xe"))

    def argv_at(root):
        return (["--dataset", "coco"] + g.ARGV
                + ["--checkpoint_path", root,
                   "--log_dir", os.path.join(root, "log"), "--sample_rl",
                   "--max_steps", "2", "--max_epochs", "1",
                   "--batch_size", "7"])

    runs = run_both(tmp_path, torch_train.main, argv_at,
                    "coco_cap/exp_rl_last", prepare)
    got = check_runs(runs, lr=5e-4)
    assert got["lines"][0].startswith("restored XE best")
