"""Device selection for the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless the caller names another device. A CUDA device
    that is not present raises: the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vsrcic_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    return dev


def as_tensor(x, device, dtype=None):
    """A tensor or array-like on `device`, in `dtype` (its own if None)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_device(tree, device):
    """A nested dict of tensors or array-likes, on `device`."""
    return {k: (to_device(v, device) if isinstance(v, dict)
                else as_tensor(v, device))
            for k, v in tree.items()}
