"""The weight bridge between the JAX package's parameter trees and the port.

Both packages keep torch's layouts (`core/nn.py`), so the bridge is a pure
key mapping: a nested dict of numpy arrays (a JAX tree after `np.asarray`)
becomes the same nested dict of tensors, and back. `flatten`/`unflatten`
give the ``"a.b.weight"`` keys of a torch ``state_dict``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """Nested dict of array-likes -> nested dict of tensors on `device`."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = params_from_jax(val, device)
        else:
            out[key] = torch.from_numpy(np.array(val, copy=True)).to(device)
    return out


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().cpu().numpy())
            for k, v in params.items()}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{'a': {'b': {'weight': x}}} -> {'a.b.weight': x}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a.b.weight': x} -> {'a': {'b': {'weight': x}}}."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        *parents, leaf = key.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def seeded_params(template: Mapping[str, Any], seed: int) -> Dict[str, Any]:
    """A nested dict of f32 numpy arrays with `template`'s keys and leaf
    shapes, drawn by numpy's RandomState(seed) leaf by leaf in sorted key
    order: 2-D leaves uniform within +-sqrt(6 / (fan_in + fan_out)) (the
    xavier_uniform range), 1-D leaves within +-0.1, plus 1 for a "weight"
    (a layer norm's scale). numpy's legacy generator gives the same values
    on every machine, so a golden fixture can name its weights by a seed
    instead of storing them."""
    rng = np.random.RandomState(seed)
    flat = flatten(template)
    out = {}
    for key in sorted(flat):
        shape = tuple(flat[key].shape)
        if len(shape) >= 2:
            a = math.sqrt(6.0 / (shape[0] + math.prod(shape[1:])))
            val = rng.uniform(-a, a, shape)
        else:
            val = rng.uniform(-0.1, 0.1, shape)
            if key.endswith("weight"):
                val = val + 1.0
        out[key] = val.astype(np.float32)
    return unflatten(out)
