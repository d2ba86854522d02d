"""Whole runs on the CPU at tiny shapes (the card check skipped), the
card check itself, and the modules check."""
from __future__ import annotations

import shutil
import subprocess
import sys
import types

import pytest
import torch

from vsrbench import run
from vsrbench.tests.tiny import CELLS, REPO, run_cell, tiny_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(root, cell, trace):
    rc, line = run_cell(root, cell, trace=trace, seconds=0.5)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(
            line["device"])
        assert "breakdown" in line
        assert all(not k.startswith(("captions", "batch", "train", "setup"))
                   for k in line["metrics"])
    else:
        assert "setup_s" in line["metrics"]
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])


def test_bare_directory_fails(tmp_path):
    """A directory with BENCHMARK.json and vsrbench/ alone (no program)
    exits non-zero and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "vsrbench", tmp_path / "vsrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "vsrbench.run", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_jax_loaded_means_no_result(root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run_cell(root, CELLS[1], seconds=0.2)
    assert rc == 3 and line is None
    assert "jax" in capsys.readouterr().err
