"""R-level SSP: Sinkhorn soft-permutation network.

Counterpart of `vsrcic_tpu/models/sinkhorn.py` (reference
models/sinkhorn_network.py:5-51): a per-row MLP over concatenated (visual,
text, position) region features, then iterative column/row normalization
of exp(score / tau) (`ops/sinkhorn.py`: the CUDA kernel for CUDA tensors,
its plain version for CPU tensors). By default the normalization carries a
gradient (the kernel forward, the plain version replayed backward), so the
trainer differentiates through it; eval callers run under no_grad.

Fidelity note (SURVEY.md M3): the reference slices its 2352-d input as
[:300] -> W1_txt, [300:2348] -> W1_vis, [2348:] -> pos, but every caller
concatenates (vis 2048, txt 300, pos 4) — so the "txt" branch actually sees
the first 300 visual dims. The slicing (offsets) is replicated, not the
names, because the released checkpoints were trained this way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vsrcic_tpu_torch.core import nn
from vsrcic_tpu_torch.ops.sinkhorn import EPS  # noqa: F401
from vsrcic_tpu_torch.ops.sinkhorn import sinkhorn_normalize_grad


@dataclasses.dataclass(frozen=True)
class SinkhornConfig:
    n: int = 10          # permutation size
    n_iters: int = 20
    tau: float = 0.1
    txt_dim: int = 300   # slice sizes of the 2352-d input (see module doc)
    vis_dim: int = 2048
    pos_dim: int = 4


def init_sinkhorn_params(gen: torch.Generator,
                         cfg: SinkhornConfig) -> Dict[str, Any]:
    """xavier_normal weights / zero biases (ref :18-28); tensors on the CPU."""

    def lin(i, o):
        return {"weight": nn.xavier_normal(gen, (o, i)),
                "bias": torch.zeros((o,))}

    return {
        "W1_txt": lin(cfg.txt_dim, 128),
        "W1_vis": lin(cfg.vis_dim, 512),
        "W2_vis": lin(512, 128),
        "W_fc_pos": lin(256 + cfg.pos_dim, 256),
        "W_fc": lin(256, cfg.n),
    }


def sinkhorn_net_apply(params, cfg: SinkhornConfig, seq,
                       normalize=sinkhorn_normalize_grad):
    """seq: (B, N, txt+vis+pos) f32 -> soft permutation (B, N, N).

    Default dims reproduce the reference's 2352-d slicing exactly
    (:300 / 300:2348 / 2348:, incl. the mislabeled-slice quirk — module
    docstring); other dims serve reduced-width tests. `normalize` is
    `ops.sinkhorn.sinkhorn_normalize_grad` (the kernel for CUDA tensors,
    differentiable), the bare wrapper `sinkhorn_normalize`, or the plain
    version."""
    x_txt = seq[:, :, :cfg.txt_dim]
    x_vis = seq[:, :, cfg.txt_dim:cfg.txt_dim + cfg.vis_dim]
    x_pos = seq[:, :, cfg.txt_dim + cfg.vis_dim:]
    x_txt = torch.relu(nn.linear(params["W1_txt"], x_txt))
    x_vis = torch.relu(nn.linear(params["W1_vis"], x_vis))
    x_vis = torch.relu(nn.linear(params["W2_vis"], x_vis))
    x = torch.cat([x_txt, x_vis, x_pos], dim=-1)
    x = torch.relu(nn.linear(params["W_fc_pos"], x))
    x = torch.tanh(nn.linear(params["W_fc"], x))
    return normalize(x.contiguous(), cfg.n_iters, cfg.tau)
