"""Import released PyTorch ``.pth`` checkpoints into the port's param trees.

Counterpart of `vsrcic_tpu/utils/torch_import.py`, with tensors for leaves
where JAX has `jnp` arrays; the key nesting is the same. Because both
packages keep torch parameter layout (Linear weights are ``(out, in)``,
LSTM gates packed i,f,g,o), a reference state_dict maps onto the params by
pure key nesting — no transposes. Covers the reference checkpoint schemes:
the captioner's full training dict with ``state_dict`` inside (reference
coco_scripts/train.py:221-230) and the bare ``model-tr.pth`` /
``model-sh.pth`` planner state dicts (train_region_sort.py:42-54).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def nest_state_dict(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a.b.weight': t} -> {'a': {'b': {'weight': CPU tensor}}}."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().clone()
        else:
            val = torch.from_numpy(np.array(val))
        node[parts[-1]] = val
    return out


def import_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a .pth file; unwrap a training dict's ``state_dict`` if present."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return nest_state_dict(blob)
