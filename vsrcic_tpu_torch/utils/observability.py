"""Tracing, metric logging and NaN guards (SURVEY.md §5 aux subsystems).

Counterpart of `vsrcic_tpu/utils/observability.py`, with torch in place of
jax:

  * `MetricLogger` — structured scalar journal (JSONL, one
    ``{"t", "step", key}`` record per scalar) + optional TensorBoard event
    writing when `tensorboardX`/`tensorboard` is present, same scalar names
    as the reference ('train_loss', ...). The journal needs neither.
  * `trace` — context manager around `torch.profiler` (CPU and, when there
    is a card, CUDA activities) that writes a Chrome trace under
    `VSRCIC_TRACE_DIR` or an explicit path; a no-op without either.
  * `check_finite` — host-side NaN/Inf guard mirroring the reference's
    tripwire, raising instead of dropping into pdb; `enable_nan_debug()`
    turns on autograd's anomaly mode, which raises where a backward
    function returns NaN.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self.log_dir = log_dir
        self.name = name
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, name + ".jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self._tb = SummaryWriter(log_dir)
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def add_scalar(self, key: str, value, iteration: int):
        value = float(value)
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "step": iteration, key: value}) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(key, value, iteration)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """torch.profiler trace context, written as a Chrome trace
    (`trace_<pid>_<time ns>.json`) under the directory; a no-op when no
    directory is configured."""
    trace_dir = trace_dir or os.environ.get("VSRCIC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


def check_finite(name: str, value) -> float:
    """Raise on NaN/Inf loss (reference pdb tripwire, sort_model.py:101)."""
    v = float(value)
    if not np.isfinite(v):
        raise FloatingPointError("non-finite %s: %r" % (name, v))
    return v


def enable_nan_debug(enable: bool = True):
    import torch
    torch.autograd.set_detect_anomaly(enable)
