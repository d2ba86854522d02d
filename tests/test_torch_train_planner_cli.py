"""The port's planner train CLIs (`vsrcic_tpu_torch.cli.train_sinkhorn`,
`.train_region_sort`) against the JAX ones on the synthetic COCO and
Flickr worlds, on the CPU.

Sinkhorn: both CLIs resume the golden fixture's JAX-initialised `model-sh`
(vsrcic_tpu_torch/testdata/golden_train_cli.npz) with the same argv and
take three steps, COCO with the 'images' normalisation and Flickr with
'pairs': per-step losses within rtol 1e-4, the saved weights within rtol
1e-4 / atol 1e-6 (strided samples of at most 2048 entries per weight, as
the fixture holds them); the port's normalisation is the kernel's plain
version here. The JAX runs are held to the fixture too (stale: `python
tests/torch_parity.py --train-cli`).

S-SSP: the CLI cannot switch dropout off, and the port's dropout masks are
not JAX's, so the two are compared at the trainer's boundary: the
(verbs, det_sr, gt_sr) batches each CLI hands `SSPTrainer.step` (captured
by a wrapper; the port's then steps, JAX's returns 0) are equal, over a
fresh run and its resume; the resume prints the same epoch and step; the
saved cfg blob is equal.
Also the port's side of tests/test_cli_lifecycle.py's planner cases.
JAX's CLIs write npz here (orbax hidden), as where orbax is absent.
"""
import os
import re

import numpy as np
import pytest

from vsrcic_tpu.train import planners as jax_planners
from vsrcic_tpu_torch.cli import train_region_sort as torch_region_sort
from vsrcic_tpu_torch.cli import train_sinkhorn as torch_sinkhorn
from vsrcic_tpu_torch.core.checkpoint import _load_npz
from vsrcic_tpu_torch.tools import train_cli_golden as g
from vsrcic_tpu_torch.train import planners as torch_planners

import torch_parity as tp

TINY = ["--synthetic", "--synthetic_images", "16", "--batch_size", "8",
        "--platform", "cpu", "--seed", "7"]
TINY_SSP = ["--ssp_hidden_size", "16", "--ssp_embed_size", "16",
            "--ssp_layers", "1"]


@pytest.fixture(scope="module")
def golden():
    return g.load_golden()


@pytest.mark.parametrize("run", ["sinkhorn_coco", "sinkhorn_flickr"])
def test_sinkhorn_cli_matches_jax(run, golden, tmp_path):
    want, want_params = tp.run_jax_train_cli(run, g.init_flat(golden, run),
                                             str(tmp_path / "jax"))
    g.check_run("JAX %s against the fixture (stale: python "
                "tests/torch_parity.py --train-cli)" % run, want,
                want_params, *g.golden_run(golden, run))
    root = str(tmp_path / "torch")
    got = g.run_captured(torch_sinkhorn.main, g.golden_flags(
        golden, run, root) + ["--platform", "cpu"])
    assert got["steps"] == want["steps"] == [0, 1, 2]
    g.check_run("port %s against JAX" % run, got, g.saved_params(root, run),
                want["losses"], want_params, want["lines"])
    resumed = [ln for ln in got["out"] if ln.startswith("resumed Sinkhorn")]
    assert resumed and resumed[0].endswith("(epoch -1, step 0)")


def capture_steps(monkeypatch, cls, then_step):
    """Record the (verbs, det_sr, gt_sr) of every `cls.step` call, then
    step, or return a loss of 0 without stepping."""
    seen = []
    step = cls.step

    def recording(self, verbs, det_sr, gt_sr, rng):
        seen.append(tuple(np.asarray(x) for x in (verbs, det_sr, gt_sr)))
        return step(self, verbs, det_sr, gt_sr, rng) if then_step else 0.0

    monkeypatch.setattr(cls, "step", recording)
    return seen


def run_ssp(main, root, extra, capsys):
    main(["--checkpoint_path", root] + extra + TINY_SSP + TINY)
    return capsys.readouterr().out


@pytest.mark.parametrize("dataset", ["coco", "flickr"])
def test_ssp_cli_matches_jax_at_the_step(dataset, tmp_path, monkeypatch,
                                         capsys):
    from vsrcic_tpu.cli import train_region_sort as jax_region_sort
    out = {}
    # JAX's steps are not taken: each new group count would compile its
    # step anew, and nothing compared here depends on them
    for pkg, main, cls in (
            ("jax", jax_region_sort.main, jax_planners.SSPTrainer),
            ("torch", torch_region_sort.main, torch_planners.SSPTrainer)):
        seen = capture_steps(monkeypatch, cls, then_step=pkg == "torch")
        root = str(tmp_path / pkg)
        sub = os.path.join(root, "%s_s_ssp" % dataset)
        with tp.no_orbax():
            run_ssp(main, root, ["--dataset", dataset, "--max_steps", "2"],
                    capsys)
            n_fresh = len(seen)
            text = run_ssp(main, root, ["--dataset", dataset,
                                        "--max_steps", "4",
                                        "--start_from", sub], capsys)
        resumed = re.search(r"resumed S-SSP from (\S+) \(epoch (-?\d+), "
                            r"step (\d+)\)", text)
        assert resumed and resumed.group(1) == os.path.join(sub, "model-tr")
        blob = _load_npz(os.path.join(sub, "model-tr"))
        out[pkg] = (seen, n_fresh, resumed.groups()[1:], blob["cfg"],
                    int(blob["step"]), int(blob["epoch"]))
        assert "s-ssp loss" in text
    (got, n_got, res_got, cfg_got, *cnt_got) = out["torch"]
    (want, n_want, res_want, cfg_want, *cnt_want) = out["jax"]
    assert n_got == n_want == 2 and len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.shape == y.shape and np.array_equal(x, y)
    assert res_got == res_want and cnt_got == cnt_want
    assert sorted(cfg_got) == sorted(cfg_want)
    for k in cfg_want:
        assert np.array_equal(cfg_got[k], cfg_want[k]), k


def test_planner_clis_save_and_resume(tmp_path, capsys):
    root = str(tmp_path / "saved")
    for main, sub, extra in ((torch_region_sort.main, "coco_s_ssp", TINY_SSP),
                             (torch_sinkhorn.main, "coco_sinkhorn", [])):
        main(["--dataset", "coco", "--checkpoint_path", root,
              "--max_steps", "2"] + extra + TINY)
        capsys.readouterr()
        main(["--dataset", "coco", "--checkpoint_path", root,
              "--max_steps", "4", "--start_from",
              os.path.join(root, sub)] + TINY)
        out = capsys.readouterr().out
        assert re.search(r"resumed .* \(epoch 0, step 2\)", out), out[-500:]


def test_planner_clis_flickr_smoke(tmp_path, capsys):
    """The Flickr world's 7-output field indexing and the 'pairs'
    normalisation."""
    root = str(tmp_path / "saved")
    torch_region_sort.main(["--dataset", "flickr", "--checkpoint_path", root,
                            "--max_steps", "1"] + TINY_SSP + TINY)
    out = capsys.readouterr().out
    assert "s-ssp loss" in out
    assert os.path.isfile(os.path.join(root, "flickr_s_ssp", "model-tr.npz"))
    torch_sinkhorn.main(["--dataset", "flickr", "--checkpoint_path", root,
                         "--max_steps", "1"] + TINY)
    out = capsys.readouterr().out
    assert "sinkhorn loss" in out
    assert os.path.isfile(os.path.join(root, "flickr_sinkhorn",
                                       "model-sh.npz"))
