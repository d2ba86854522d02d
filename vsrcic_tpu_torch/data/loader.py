"""Host prefetch pipeline.

The reference relies on torch DataLoader worker processes doing per-item HDF5
opens (SURVEY.md §2.4); here a thread-pool prefetcher overlaps field
preprocessing + batch collation with device compute and keeps a bounded queue
of ready batches. Threads (not processes) because the packed memmap store
reads release the GIL in numpy and the preprocessing is numpy-bound; the
native C++ reader (csrc/packed_reader.cpp) plugs in underneath the same API.

A copy of `vsrcic_tpu/data/loader.py`, plus `cuda_put`, the put_fn that
`DevicePrefetchLoader` takes on the card (JAX's is a `jax.device_put`).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np


class PrefetchLoader:
    """Wraps any iterable loader with background prefetch of `depth` batches.

    Single producer thread by design: the wrapped loader is an opaque
    iterator, so the per-batch work happens inside its `next()` — multiple
    producers would just serialize on the iterator. Per-example parallelism
    belongs in `DataLoader(num_workers=)` underneath.
    """

    def __init__(self, loader: Iterable, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: list = []

        def producer():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as e:  # surfaced to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item


class _MappedIterable:
    """Apply fn to each item of an iterable, preserving len()."""

    def __init__(self, loader, fn):
        self.loader, self.fn = loader, fn

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for item in self.loader:
            yield self.fn(item)


class DevicePrefetchLoader(PrefetchLoader):
    """Prefetch + device-put-AHEAD host->device transfer of each batch.

    `put_fn` (e.g. `functools.partial(cuda_put, device="cuda")`) runs in
    the PRODUCER thread, so batch k+1's asynchronous transfer is dispatched
    while the consumer is still computing on batch k — the copy rides under
    the step instead of serializing in front of it. With `put_fn` applied
    at yield time (the naive form) the consumer's step k would always wait
    on a transfer that only started when the batch was yielded. `depth`
    bounds the number of batches resident on device ahead of the consumer.
    """

    def __init__(self, loader, put_fn: Callable[[Any], Any], depth: int = 2):
        super().__init__(_MappedIterable(loader, put_fn), depth=depth)
        self.put_fn = put_fn


def cuda_put(batch, device):
    """A batch with every numpy array in it (through dicts, lists and
    tuples) copied to `device` as a tensor, through pinned memory with
    `non_blocking=True`: the copy is enqueued and this returns at once.
    Other leaves (ids, strings) stay as they are. Meant as the put_fn of
    `DevicePrefetchLoader`, which calls it in the producer thread.

    Ordering on a CUDA device: the copies are enqueued on the device's
    default stream, which is the stream a consumer runs its step on unless
    it selects another; a step on that stream starts after the copies end.
    A consumer on another stream must make it wait on this one first. Each
    pinned buffer comes from PyTorch's caching host allocator, which
    records the copy's event with it and hands the block out again only
    after that event."""
    import contextlib
    import torch

    cuda = torch.device(device).type == "cuda"

    def put(x):
        if isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cuda:
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            vals = [put(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
        return x

    with (torch.cuda.stream(torch.cuda.default_stream(device)) if cuda
          else contextlib.nullcontext()):
        return put(batch)
