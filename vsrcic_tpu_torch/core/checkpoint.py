"""Checkpointing: the npz layout of `vsrcic_tpu/core/checkpoint.py`, read and
written without JAX.

Counterpart of the JAX package's module. A checkpoint is a nested dict
({params, opt_state, step, meta, cfg}) flattened into one `.npz` file, keys
`a/b/c` with `#i` for list items (`_flatten` / `_save_npz` / `_load_npz`
are copies). Each package reads the other's files: JAX's `_load_npz` reads
what `save_checkpoint` writes here, and `restore_checkpoint` here reads
what JAX's `_save_npz` writes.

With orbax installed, JAX's `save_checkpoint` writes an orbax directory
instead. orbax needs JAX, so a directory path raises here, and its message
names the npz route. `import_torch_state_dict` (utils/torch_import.py)
converts released reference checkpoints into the port's params.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def _host(x):
    """A tensor leaf as a numpy array (f32 for bf16, which numpy lacks)."""
    if hasattr(x, "detach"):
        t = x.detach().cpu()
        if not t.dtype.is_floating_point or t.dtype.itemsize >= 4:
            return t.numpy()
        return t.float().numpy()
    return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def save_checkpoint(path: str, tree: Dict[str, Any]):
    """Save a nested dict of tensors, arrays and scalars as `path`.npz (the
    JAX package's npz layout)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save_npz(path, _tree_map(_host, tree))


def restore_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Read `path`.npz into a nested dict. Numeric leaves are numpy arrays,
    or tensors on `device` when one is named; other leaves (strings in a
    saved cfg block) stay numpy. The models move their params to their own
    device (`utils/device.py::to_device`), so callers that hand the tree to
    a model need not name one."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise ValueError(
            "%s is an orbax checkpoint directory, which only the JAX package "
            "reads (orbax needs JAX); write the checkpoint as npz instead: "
            "vsrcic_tpu.core.checkpoint._save_npz(path, tree), or "
            "save_checkpoint with orbax not installed" % path)
    tree = _load_npz(path)
    if device is None:
        return tree
    import torch

    def _to_device(x):
        a = np.asarray(x)
        return (torch.from_numpy(np.array(a)).to(device)
                if a.dtype.kind in "biufc" else x)

    return _tree_map(_to_device, tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + str(k) + "/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + "#%d/" % i))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _save_npz(path: str, tree):
    flat = _flatten(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def _load_npz(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    out: Dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return out


class CheckpointManager:
    """best/last rotation with a metrics journal (reference scheme parity:
    best-checkpoint on val CIDEr, patience counter — train.py:237-251)."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.name = name
        os.makedirs(root, exist_ok=True)
        self._meta_path = os.path.join(root, name + "_meta.json")
        self.meta = {"best_metric": -float("inf"), "patience": 0, "epoch": -1}
        if os.path.isfile(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def step(self, tree: Dict[str, Any], metric: float, epoch: int,
             patience_limit: int = 5) -> bool:
        """Save last (+best if improved). Returns True when patience exhausted."""
        self.meta["epoch"] = epoch
        if metric >= self.meta["best_metric"]:
            self.meta["best_metric"] = metric
            self.meta["patience"] = 0
            save_checkpoint(os.path.join(self.root, self.name + "_best"), tree)
        else:
            self.meta["patience"] += 1
        save_checkpoint(os.path.join(self.root, self.name + "_last"), tree)
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f)
        return self.meta["patience"] >= patience_limit

    def restore(self, best: bool = True) -> Optional[Dict[str, Any]]:
        tag = "_best" if best else "_last"
        path = os.path.join(self.root, self.name + tag)
        if os.path.isdir(path) or os.path.isfile(path + ".npz"):
            return restore_checkpoint(path)
        return None
