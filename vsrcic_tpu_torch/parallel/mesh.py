"""The data axis over `torch.distributed`: the mesh and its collectives.

Counterpart of `vsrcic_tpu/parallel/mesh.py`. JAX runs one controller over
many devices and GSPMD inserts the collectives; the port runs one process
per device (`parallel/launch.py` starts them) and calls the collectives
itself. A `DataMesh` is one process's view of the data axis: its rank, the
world size, its device and the backend of the default process group.

  * `shard_batch`: this rank's block of a batch whose leading axis is
    zero-padded to a multiple of the size, as JAX pads and then shards;
  * `replicate`: rank 0's tensors broadcast, so that every rank holds the
    same bits on its device;
  * `all_gather_blocks`: equal leading-axis blocks put back in rank order;
  * `all_reduce_tree`: a nested dict of tensors summed over the ranks
    through one flat buffer per dtype (the gradient psum GSPMD inserts).

JAX's `data_sharding` and `replicated` are `NamedSharding`s and have no
counterpart: a tensor lives on one rank's device, and whether it is a block
or a copy is said by the function that made it. JAX's `model` axis is kept
only in its types and no caller sets it, so `make_mesh` takes `n_model` 1
alone.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vsrcic_tpu_torch.utils.device import as_tensor, resolve_device
from vsrcic_tpu_torch.utils.params import flatten, unflatten


@dataclass(frozen=True)
class DataMesh:
    rank: int
    size: int
    device: torch.device
    backend: str

    def bounds(self, n: int):
        """(lo, hi): this rank's rows of n rows padded to a multiple of
        the size."""
        per = -(-n // self.size)
        return self.rank * per, (self.rank + 1) * per


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> DataMesh:
    """This process's mesh over the initialised default process group.

    devices: one per rank (rank r runs on devices[r]); None takes
    `cuda:LOCAL_RANK` under NCCL and the CPU under gloo."""
    if n_model != 1:
        raise ValueError("vsrcic_tpu_torch: the mesh has a data axis only; "
                         "n_model must be 1, got %d" % n_model)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "vsrcic_tpu_torch.parallel.launch.run or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError("n_data %d differs from the world size %d"
                         % (n_data, world))
    backend = dist.get_backend()
    if devices is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
                  if backend == "nccl" else torch.device("cpu"))
    else:
        if len(devices) != world:
            raise ValueError("%d devices for a world of %d"
                             % (len(devices), world))
        device = torch.device(devices[rank])
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DataMesh(rank, world, device, backend)


def same_device(a, b) -> bool:
    """Whether two devices are one: "cuda" is the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def mesh_device(mesh, device):
    """The device of an entry point given `mesh` and `device`: the mesh's
    under a mesh (a `device` naming another raises), else
    `resolve_device(device)`. A mesh that is not a `DataMesh` raises
    TypeError."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, DataMesh):
        raise TypeError("mesh must be a vsrcic_tpu_torch.parallel.DataMesh, "
                        "got %s" % type(mesh).__name__)
    if device is not None and not same_device(device, mesh.device):
        raise ValueError("device %s differs from the mesh's %s"
                         % (device, mesh.device))
    return mesh.device


def block_of(x, mesh: DataMesh, fill=0):
    """This rank's block of x (array or tensor) with its leading axis
    padded to a multiple of the mesh's size: by `fill`, or by repeats of
    the last row when fill is None. Only the block is built."""
    n = x.shape[0]
    lo, hi = mesh.bounds(n)
    part = x[min(lo, n):min(hi, n)]
    pad = (hi - lo) - part.shape[0]
    if not pad:
        return part
    if isinstance(x, torch.Tensor):
        rows = (x[-1:].expand((pad,) + tuple(x.shape[1:])) if fill is None
                else x.new_full((pad,) + tuple(x.shape[1:]), fill))
        return torch.cat([part, rows])
    x = np.asarray(x)
    rows = (np.repeat(x[-1:], pad, 0) if fill is None
            else np.full((pad,) + x.shape[1:], fill, x.dtype))
    return np.concatenate([part, rows])


def shard_batch(batch, mesh: DataMesh):
    """A batch (an array or tensor, or a tuple, list or dict of them) ->
    this rank's block of each, zero-padded as `block_of`, on the mesh's
    device."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return as_tensor(block_of(batch, mesh), mesh.device)


def replicate(tree, mesh: DataMesh):
    """A copy of a nested dict of tensors or arrays on the mesh's device,
    every leaf broadcast from rank 0."""
    flat = {k: as_tensor(v, mesh.device).clone(
        memory_format=torch.contiguous_format)
        for k, v in flatten(tree).items()}
    for v in flat.values():
        dist.broadcast(v, src=0)
    return unflatten(flat)


def all_gather_blocks(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's block x (the same shape on each) -> their concatenation
    along the leading axis, in rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x)
    return torch.cat(out)


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor, outside autograd)."""
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def all_reduce_tree(tree, mesh: DataMesh):
    """A nested dict of tensors summed over the ranks, one all-reduce per
    dtype over a flat buffer of its leaves."""
    flat = flatten(tree)
    out = {}
    for dtype in sorted({v.dtype for v in flat.values()}, key=str):
        keys = [k for k, v in flat.items() if v.dtype == dtype]
        buf = torch.cat([flat[k].reshape(-1) for k in keys])
        dist.all_reduce(buf)
        for k, part in zip(keys, buf.split([flat[k].numel() for k in keys])):
            out[k] = part.view(flat[k].shape)
    return unflatten({k: out[k] for k in flat})


def broadcast_object(obj, mesh: DataMesh):
    """Rank 0's picklable obj on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.device)
    return box[0]


def barrier(mesh: DataMesh):
    """Every rank waits for all (an all-reduce on the mesh's device, which
    both backends take)."""
    dist.all_reduce(torch.zeros((1,), device=mesh.device))
