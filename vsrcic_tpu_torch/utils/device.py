"""Device selection for the port's entry points."""
from __future__ import annotations

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
