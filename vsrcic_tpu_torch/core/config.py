"""Dataclass config tree for the four pipelines.

The reference scatters configuration across `config.py` path constants,
per-script argparse and hyperparameters hardcoded in class definitions
(SURVEY.md §5). Here each pipeline has one serializable dataclass tree; the
CLIs keep reference-compatible flags and materialize these configs, and
checkpoints embed them (the reference stores its argparse `opt` inside the
captioner checkpoint and reads it back at eval, train.py:222 /
eval_coco.py:40 — `to_dict`/`from_dict` serve the same role).

A copy of `vsrcic_tpu/core/config.py` over the port's own model configs
(`models/captioner.py`, `models/s_ssp.py`, `models/sinkhorn.py`), which
have the JAX ones' fields and defaults.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from vsrcic_tpu_torch.models.captioner import CaptionerConfig
from vsrcic_tpu_torch.models.s_ssp import SSPConfig
from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "coco"                # coco | flickr
    coco_root: str = "datasets/coco"
    flickr_root: str = "datasets/flickr"
    synthetic: bool = False
    feat_dim: int = 2048
    max_detections: int = 100
    fix_length: int = 20                 # captioner control length
    planner_fix_length: int = 10
    compact_control: bool = True         # ship det-ids, expand on device
    vocab_min_freq: int = 5


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 5e-4
    step_size: int = 3                   # StepLR (captioner XE)
    gamma: float = 0.8
    decay_every: int = 3                 # planner manual decay
    decay_rate: float = 0.6
    patience: int = 5
    batch_size: int = 100
    max_epochs: int = 100
    stop_epoch: Optional[int] = None     # planners stop at 20/30


@dataclass(frozen=True)
class CaptionerPipelineConfig:
    model: CaptionerConfig = field(default_factory=CaptionerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    sample_rl: bool = False
    gate_loss_weight: float = 4.0


@dataclass(frozen=True)
class PlannerPipelineConfig:
    ssp: SSPConfig = field(default_factory=SSPConfig)
    sinkhorn: SinkhornConfig = field(default_factory=SinkhornConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(
        lr=1e-4, batch_size=20, stop_epoch=20))


@dataclass(frozen=True)
class EvalPipelineConfig:
    data: DataConfig = field(default_factory=DataConfig)
    beam_size: int = 5
    fixed_len: int = 10
    sinkhorn_len: int = 10
    det: bool = False                    # detected regions
    gt: bool = False                     # gt verb
    use_fused_attention: bool = False
    batch_size: int = 16


def to_dict(cfg) -> Dict[str, Any]:
    if dataclasses.is_dataclass(cfg):
        return {k: to_dict(v) for k, v in dataclasses.asdict(cfg).items()}
    return cfg


def from_dict(cls, d: Dict[str, Any]):
    """Rebuild a (nested) dataclass from to_dict output."""
    import typing
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) \
                and isinstance(v, dict):
            v = from_dict(ftype, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg, path: str):
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(cls, path: str):
    with open(path) as f:
        return from_dict(cls, json.load(f))
