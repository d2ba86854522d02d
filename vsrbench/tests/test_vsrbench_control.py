"""The control, the reference one precision below the configuration's in
the program's place, comes out not correct under the committed limits,
while the program's own readings pass them; at tiny shapes. On the CPU
the control's weights are rounded to TF32's mantissa (no TF32 there); the
test marked `cuda` runs it with TF32 on, on the card."""
from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from vsrbench import control, layout
from vsrbench.tests.tiny import CELLS, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def readings(root, cell, device, seeds="5,6,7"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        control.main(["--workload", cell, "--seeds", seeds, "--faults"],
                     root=root, device=device)
    return json.loads(out.getvalue().strip().splitlines()[-1])["summary"]


def check(root, cell, device):
    limits = layout.cell(cell, root).limits
    got = readings(root, cell, device)
    assert all(v <= limits[k] for k, v in got["program"].items())
    assert any(v > limits[k] for k, v in got["control"].items())
    for fault in set(got) - {"program", "control"}:
        assert any(v > limits[k] for k, v in got[fault].items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_cpu(root, cell):
    check(root, cell, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    check(root, cell, "cuda")
