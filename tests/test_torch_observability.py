"""The port's observability module (`vsrcic_tpu_torch.utils.observability`)
against `vsrcic_tpu.utils.observability`: the same JSONL records save for
their time `t`, the same NaN guard, a trace that is a no-op without a
directory and writes a Chrome trace with one (torch.profiler in place of
jax.profiler), and a NaN debug switch that makes a NaN in a backward
raise (autograd's anomaly mode in place of jax_debug_nans)."""
import json
import os

import numpy as np
import pytest
import torch

from vsrcic_tpu.utils import observability as jax_obs
from vsrcic_tpu_torch.utils import observability as torch_obs

SCALARS = [("train_loss", 1.5, 0), ("train_loss", np.float32(1.25), 1),
           ("val_cider", torch.tensor(0.5), 1), ("train_loss", 7, 2)]


def records(mod, log_dir):
    log = mod.MetricLogger(str(log_dir), name="t")
    for key, value, step in SCALARS:
        log.add_scalar(key, value, step)
    log.close()
    with open(os.path.join(log_dir, "t.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_records_match_jax(tmp_path):
    got = records(torch_obs, tmp_path / "torch")
    want = records(jax_obs, tmp_path / "jax")
    assert len(got) == len(want) == len(SCALARS)
    for g, w in zip(got, want):
        assert set(g) == set(w) and isinstance(g.pop("t"), float)
        w.pop("t")
        assert g == w
    assert got[1] == {"step": 1, "train_loss": 1.25}


def test_metric_logger_appends(tmp_path):
    records(torch_obs, tmp_path)
    assert len(records(torch_obs, tmp_path)) == 2 * len(SCALARS)


def test_metric_logger_disabled():
    log = torch_obs.MetricLogger(None)
    log.add_scalar("x", 1.0, 0)  # no-op, no crash
    log.close()


@pytest.mark.parametrize("value", [float("nan"), np.inf, -np.inf])
def test_check_finite_raises_as_jax(value):
    assert torch_obs.check_finite("loss", 1.0) == jax_obs.check_finite(
        "loss", 1.0) == 1.0
    for mod in (torch_obs, jax_obs):
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            mod.check_finite("loss", value)


def test_trace_noop_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("VSRCIC_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with torch_obs.trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("via_env", [False, True])
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, via_env):
    trace_dir = tmp_path / "trace"
    if via_env:
        monkeypatch.setenv("VSRCIC_TRACE_DIR", str(trace_dir))
    with torch_obs.trace(None if via_env else str(trace_dir)):
        (torch.arange(64.0).reshape(8, 8) @ torch.ones(8, 8)).sum()
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_nan_debug_raises_in_a_backward():
    def backward_of_sqrt_at_minus_one():
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        torch.sqrt(x).sum().backward()
        return x.grad

    assert torch.isnan(backward_of_sqrt_at_minus_one()[0])
    torch_obs.enable_nan_debug(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            backward_of_sqrt_at_minus_one()
    finally:
        torch_obs.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(backward_of_sqrt_at_minus_one()[0])
