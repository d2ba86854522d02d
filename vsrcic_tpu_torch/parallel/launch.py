"""Start the ranks of a data-parallel run: one process per device.

JAX's single controller drives every device from one process and needs no
launcher. The port follows PyTorch's idiom, which NCCL wants: one process
per device, each a rank of the default process group. `run(fn, devices,
*args)` runs `fn(*args)` on `len(devices)` ranks, rank r on `devices[r]`,
and returns rank 0's result:

  * under `torchrun` (WORLD_SIZE set) this process is one of the ranks and
    runs fn in place; the world size must be len(devices);
  * a world of one runs in this process;
  * otherwise it spawns one process per rank (`torch.multiprocessing`,
    spawn), which meet on a `FileStore` in a temporary directory: no TCP
    port, so runs side by side cannot collide.

The backend follows from the devices, never from a failure: NCCL when every
rank has a card of its own, gloo on the CPU and where a card is repeated
(NCCL refuses two ranks on one card). A process group that fails to set up
raises. A rank that raises makes `run` raise with that rank's traceback, and
the other ranks are stopped. Rank 0's standard output is the run's (a
spawned rank 0's is relayed while it runs); the other ranks' is discarded.
Before any rank loads the CUDA kernels, rank 0 builds them and the others
wait. Each run prints its backend and which device each rank has, on one
line.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import tempfile
import traceback
from typing import Sequence

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

# a rank waits this long for the others at a collective before it fails
TIMEOUT = datetime.timedelta(minutes=30)


def backend_for(devices: Sequence) -> str:
    """"nccl" when every device is a distinct CUDA card, "gloo" when all
    are the CPU or a card repeats; a mix of the CPU and cards raises."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        cards = [d.index or 0 for d in devs]
        return "nccl" if len(set(cards)) == len(cards) else "gloo"
    raise ValueError("devices must be all the CPU or all CUDA cards: %s"
                     % [str(d) for d in devs])


def _normalise(devices):
    return [str(torch.device(d)) if torch.device(d).type == "cpu"
            else "cuda:%d" % (torch.device(d).index or 0) for d in devices]


def run(fn, devices: Sequence, *args):
    """fn(*args) on one rank per device; rank 0's return value."""
    devices = _normalise(devices)
    if not devices:
        raise ValueError("no devices")
    backend = backend_for(devices)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != len(devices):
            raise ValueError("torchrun started %s ranks for %d devices"
                             % (os.environ["WORLD_SIZE"], len(devices)))
        return _as_rank(fn, args, int(os.environ["RANK"]), devices, backend,
                        init_method="env://")
    if len(devices) == 1:
        with tempfile.TemporaryDirectory() as tmp:
            return _as_rank(fn, args, 0, devices, backend,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))
    return _spawn(fn, args, devices, backend)


def _as_rank(fn, args, rank, devices, backend, err_path=None, **init):
    """This process as rank `rank`: set up the default group, build the
    CUDA kernels on rank 0 (the others wait), run fn, tear the group down.
    err_path: where a failure's traceback is written before the group goes
    down (and with it the other ranks)."""
    from vsrcic_tpu_torch.utils.device import resolve_device
    device = resolve_device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            init["device_id"] = device
    dist.init_process_group(backend, rank=rank, world_size=len(devices),
                            timeout=TIMEOUT, **init)
    try:
        if rank == 0:
            print("data parallel: %s, ranks %s" % (backend, ", ".join(
                "%d:%s" % r for r in enumerate(devices))), flush=True)
        if device.type == "cuda":
            if rank == 0:
                from vsrcic_tpu_torch.ops import _build
                _build.build()
            dist.all_reduce(torch.zeros((1,), device=device))
        if rank == 0:
            return fn(*args)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            fn(*args)
        return None
    except BaseException:
        if err_path is not None:
            with open(err_path, "w") as f:
                f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, devices, backend):
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.out")
        open(out, "w").close()
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(fn, args, devices, backend, tmp),
            nprocs=len(devices), join=False, start_method="spawn")
        with open(out) as relay:
            try:
                while not ctx.join(timeout=0.2, grace_period=10):
                    sys.stdout.write(relay.read())
            except ProcessException as e:
                raise RuntimeError(_failures(tmp, len(devices))
                                   or str(e)) from e
            finally:
                sys.stdout.write(relay.read())
                sys.stdout.flush()
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _failures(tmp, n) -> str:
    """The traceback of every rank that raised (a rank whose peer failed
    raises too, and the first to exit need not be the first to fail)."""
    out = []
    for rank in range(n):
        path = os.path.join(tmp, "rank%d.err" % rank)
        if os.path.exists(path):
            with open(path) as f:
                out.append("rank %d failed:\n%s" % (rank, f.read()))
    return "\n".join(out)


def _worker(rank, fn, args, devices, backend, tmp):
    """A spawned rank: rank 0 writes its standard output to the file the
    parent relays and pickles its result there."""
    store = dist.FileStore(os.path.join(tmp, "store"), len(devices))
    out = os.path.join(tmp, "rank0.out") if rank == 0 else os.devnull
    with open(out, "a", buffering=1) as f, contextlib.redirect_stdout(f):
        res = _as_rank(fn, args, rank, devices, backend, store=store,
                       err_path=os.path.join(tmp, "rank%d.err" % rank))
    if rank == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
            pickle.dump(res, f)
