"""The port's captioner train CLI (`vsrcic_tpu_torch.cli.train`) against the
JAX one, and the port's side of tests/test_cli_lifecycle.py.

XE parity: both CLIs resume the same JAX-initialised checkpoint
(`coco_cap/exp_last` of the golden fixture,
vsrcic_tpu_torch/testdata/golden_train_cli.npz) with the same argv on the
CPU and take three steps over two epochs: the per-step `train_loss`
records of their journals agree within rtol 1e-4, the saved `exp_last`
weights within rtol 1e-4 / atol 1e-6, and the printed validation lines
are equal. The JAX run is also held to the fixture (stale: rewrite it
with `python tests/torch_parity.py --train-cli`). JAX's CLI writes npz
here (orbax hidden), as where orbax is absent.

Lifecycle, on the port's CLIs at tests/test_cli_lifecycle.py's tiny
widths: XE for two epochs writes exp_best / exp_last; SCST, with either
baseline and the fast decode (the fused attention op's plain version on
the CPU), restores the XE best and writes exp_rl_last; the eval CLI loads
the three checkpoints the port's train CLIs wrote and prints the metric
table, and JAX's eval CLI dumps the same captions from them;
`--data_parallel 2` raises NotImplementedError in every train CLI.
"""
import os
import shutil

import numpy as np
import pytest

from vsrcic_tpu.cli import eval as jax_eval
from vsrcic_tpu_torch.cli import eval as torch_eval
from vsrcic_tpu_torch.cli import train as torch_train
from vsrcic_tpu_torch.cli import train_region_sort as torch_region_sort
from vsrcic_tpu_torch.cli import train_sinkhorn as torch_sinkhorn
from vsrcic_tpu_torch.tools import train_cli_golden as g

import torch_parity as tp

TINY = ["--synthetic", "--synthetic_images", "16", "--batch_size", "8",
        "--platform", "cpu", "--seed", "7",
        "--rnn_size", "16", "--att_size", "8", "--input_encoding_size", "16"]
TINY_SSP = ["--ssp_hidden_size", "16", "--ssp_embed_size", "16",
            "--ssp_layers", "1"]


def _ckpt_exists(path):
    return os.path.isfile(path + ".npz")


@pytest.fixture(scope="module")
def golden():
    return g.load_golden()


@pytest.fixture(scope="module")
def xe_runs(golden, tmp_path_factory):
    """{"jax", "torch"}: (run_captured's result, saved weights) of the
    fixture's XE run through each CLI."""
    root = tmp_path_factory.mktemp("xe")
    jax_root, torch_root = str(root / "jax"), str(root / "torch")
    want = tp.run_jax_train_cli("xe", g.init_flat(golden, "xe"),
                                jax_root)
    argv = g.golden_flags(golden, "xe", torch_root) + ["--platform", "cpu"]
    got = g.run_captured(torch_train.main, argv)
    return {"jax": want, "torch": (got, g.saved_params(torch_root, "xe"))}


def test_xe_fixture_is_the_jax_cli(xe_runs, golden):
    res, saved = xe_runs["jax"]
    g.check_run("JAX XE against the fixture (stale: python "
                "tests/torch_parity.py --train-cli)", res, saved,
                *g.golden_run(golden, "xe"))


def test_xe_cli_matches_jax(xe_runs):
    (want, want_params), (got, got_params) = xe_runs["jax"], xe_runs["torch"]
    assert got["steps"] == want["steps"] == [0, 1, 2]
    assert len(got["lines"]) == 15   # restore + two validation tables
    g.check_run("port XE against JAX", got, got_params, want["losses"],
                want_params, want["lines"])
    # the same metric table each epoch, CIDEr last (ref train.py:207-219)
    names = [ln.split()[0] for ln in got["lines"][1:8]]
    assert names == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                     "METEOR(native)", "ROUGE_L", "epoch"]


@pytest.fixture(scope="module")
def xe_root(tmp_path_factory):
    """A checkpoint root after two XE epochs of the port's CLI."""
    root = str(tmp_path_factory.mktemp("saved"))
    res = g.run_captured(torch_train.main, [
        "--dataset", "coco", "--checkpoint_path", root, "--max_epochs", "2",
        "--log_dir", os.path.join(root, "log")] + TINY)
    assert sum(" val CIDEr " in ln for ln in res["out"]) == 2
    assert res["steps"] == [0, 1, 2, 3]
    assert all(np.isfinite(res["losses"]))
    return root


def test_xe_writes_best_and_last(xe_root):
    cap = os.path.join(xe_root, "coco_cap")
    for name in ("exp_best", "exp_last"):
        assert _ckpt_exists(os.path.join(cap, name)), name
    assert os.path.isfile(os.path.join(cap, "exp_meta.json"))


@pytest.mark.parametrize("baseline", ["step", "epoch"])
def test_scst_restores_xe_best(xe_root, tmp_path, baseline, capsys):
    root = str(tmp_path / "saved")
    shutil.copytree(xe_root, root)
    torch_train.main(["--dataset", "coco", "--checkpoint_path", root,
                      "--sample_rl", "--fast_decode", "--scst_baseline",
                      baseline, "--max_steps", "1", "--max_epochs", "1"]
                     + TINY)
    out = capsys.readouterr().out
    assert "restored XE best" in out
    assert "epoch 0 val CIDEr" in out
    assert _ckpt_exists(os.path.join(root, "coco_cap", "exp_rl_last"))


def test_three_checkpoints_eval_in_both_packages(tmp_path, capsys):
    """The captioner, S-SSP and Sinkhorn checkpoints that the port's train
    CLIs write load in the port's eval CLI, which prints the metric table,
    and in JAX's, which dumps the same captions."""
    root = str(tmp_path / "saved")
    torch_train.main(["--dataset", "coco", "--checkpoint_path", root,
                      "--max_epochs", "1"] + TINY)
    torch_region_sort.main(["--dataset", "coco", "--checkpoint_path", root,
                            "--max_steps", "2"] + TINY_SSP + TINY)
    torch_sinkhorn.main(["--dataset", "coco", "--checkpoint_path", root,
                         "--max_steps", "2"] + TINY)
    capsys.readouterr()
    flags = ["--dataset", "coco", "--limit", "2"] + TINY
    for name, rel in (("captioner", "coco_cap/exp_best"),
                      ("ssp", "coco_s_ssp/model-tr"),
                      ("sinkhorn", "coco_sinkhorn/model-sh")):
        path = os.path.join(root, rel)
        assert _ckpt_exists(path), path
        flags += ["--%s_ckpt" % name, path]
    want = tp.run_eval_cli(jax_eval.main, flags, tmp_path / "jax.jsonl")
    got = tp.run_eval_cli(torch_eval.main, flags, tmp_path / "torch.jsonl")
    assert got["n"] == want["n"] > 0
    assert got["dump"].splitlines() == want["dump"].splitlines()
    for name in ("Bleu_1", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR", "SPICE"):
        assert any(ln.startswith(name) for ln in got["metrics"]), name


@pytest.mark.parametrize("cli", [torch_train, torch_region_sort,
                                 torch_sinkhorn],
                         ids=["train", "train_region_sort", "train_sinkhorn"])
def test_data_parallel_raises(cli, tmp_path):
    with pytest.raises(NotImplementedError, match="data_parallel"):
        cli.main(["--dataset", "coco", "--checkpoint_path",
                  str(tmp_path), "--max_steps", "1", "--data_parallel", "2"]
                 + TINY)


def test_train_cli_stages_the_host_batch(tmp_path, capsys):
    """The train CLI's loader hands each batch through cuda_put (here to
    the CPU): the first batch's tensors hold the host arrays' dtypes,
    shapes and bytes, detections, compact ids and gate targets included."""
    with g.first_staged_batch() as seen:
        torch_train.main(["--dataset", "coco", "--checkpoint_path",
                          str(tmp_path), "--max_steps", "1",
                          "--max_epochs", "1"] + TINY)
    capsys.readouterr()
    assert g.check_staged(seen) > 0
    shapes = [tuple(a.shape) for a in seen["host"]]
    assert shapes[0][0] == 8 and shapes[0][2] == 2048   # (B, N, D)
    assert (8, 20, 20) in shapes                          # compact group ids
