"""step_products_roofline_pct.xe on made-up slices: the XE step's products
counted by hand at the cell's shapes, and nothing read where no operation
is a step product's (cuBLAS's route) or no unit was traced."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from vsrbench import harness, yardstick as ys
from vsrbench.tests.tiny import REPO


def _ctx(kernels, units=3):
    bench = REPO / "vsrbench"
    tracer = SimpleNamespace(
        window=lambda: (0.0, 1e6), kernels=kernels,
        host=[("vsrbench.unit", 0.0, 1e6)] * units,
        counters_delta=lambda: None, boundary={}, first=1)
    return SimpleNamespace(
        slice=harness.Slice(tracer, ()),
        config=json.loads((bench / "configs" / "captioner-coco.json")
                          .read_text()),
        traffic=json.loads((bench / "traffic" / "xe-b1024.json")
                           .read_text()))


def _read(ctx):
    return harness.load_metric(REPO / "vsrbench" / "metrics"
                               / "step_products_roofline_pct.xe.py").read(ctx)


def test_by_hand():
    """1024 rows x 20 steps: the groups and the word head 47.77 M
    multiply-adds a row-step, att_va 20 x 2048 x 512, the image columns
    2048 x 6000 a row; forward, recompute, dA, dW: 4, 3 and 2 times."""
    ms = 450.0      # 150 ms a step of device time, in two kernels
    ctx = _ctx([("void step_planes_kernel(x)", 0.0, 0.6 * ms * 1e3),
                ("step_planes_grad_kernel(y)", 0.0, 0.4 * ms * 1e3),
                ("gemm", 0.0, 5e5)])
    groups = 6000 * 2000 + 5000 * 1000 + 1000 * 2048 + 3 * 1000 * 512 + \
        1000 * 1000 + 4000 * 3048 + 4000 * 1000 + 1000 * 10000
    assert ys.step_macs(ctx.config["captioner"], 0, False) == groups
    rows = 1024 * 20
    macs = 3 * (4 * rows * groups + 3 * rows * 20 * 2048 * 512
                + 2 * 1024 * 2048 * 6000)
    assert _read(ctx) == pytest.approx(
        100 * 2 * macs / 989e12 / (ms / 1e3))
    assert 5 < _read(ctx) < 11


@pytest.mark.parametrize("kernels,units", [
    ([("ampere_sgemm_128x64_nn", 0.0, 5.0)], 3),
    ([("void step_planes_kernel(x)", 0.0, 5.0)], 0)])
def test_none_without_step_products(kernels, units):
    assert _read(_ctx(kernels, units)) is None
