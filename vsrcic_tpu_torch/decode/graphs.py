"""CUDA graphs of the candidate joint beam's steps.

`StepGraphs` is the runner `decode/beam.py::beam_search_joint_candidates`
takes, one for each decode shape: it holds the shape's persistent input
buffers (`inputs`, which `fill` copies each batch's inputs into) and a
graph of each step (key: the step t). A shape's first batch runs every step
as it is; its second captures each step once, on a side stream into the
shape's memory pool after a warm-up of the libraries a step calls, and
replays it; later batches replay. Without a card every step runs as it is.

A step reads only the persistent buffers, the parameters and what the
step before it returned, so a replay redoes the captured work on the batch
at hand. What a replay returns lives in the shape's pool and the next
batch's replays overwrite it: the caller copies the result out. A replay
skips the Python wrappers of the kernels, so it adds what its capture
added to their launch counters (`counted`: every attribute of each object
whose name starts with "launches") and to the counts of the recorder's
innermost open span (`beam.step`'s `step_products`). The mechanism's own
counts: `graph_captures` and `graph_replays` on that span, and
`StepGraphs.captures` and `StepGraphs.replays` over every shape.
"""
from __future__ import annotations

import torch

from vsrcic_tpu_torch.utils import observability as obs


def leaves(tree):
    """The tensors of a tree of tuples (named or not), lists and dicts, in
    order; other leaves (None, numbers) are left out."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    return []


def _map(f, tree):
    """`tree` with each tensor x replaced by f(x)."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(f, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(f, x) for x in tree)
    return tree


class CudaGraph:
    """One CUDA graph: `capture(fn)` records fn's launches on `stream`
    into the memory pool `pool` (fn's result: its tensors live there),
    `replay()` launches them on the current stream."""

    def __init__(self, stream, pool):
        self.stream, self.pool = stream, pool
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=self.pool)
            out = fn()
            self.graph.capture_end()
        cur.wait_stream(self.stream)
        return out

    def replay(self):
        self.graph.replay()


class StepGraphs:
    """A decode shape's input buffers and step graphs (see the module's
    note). inputs: a tree of tensors (`leaves`), the buffers' model;
    counted: objects whose `launches...` attributes a replay advances;
    graph: a callable that makes an object with `capture(fn) -> fn()'s
    result` and `replay()` (tests pass a stand-in), by default CUDA graphs
    where the inputs are on the card and none elsewhere."""
    captures = 0
    replays = 0

    def __init__(self, inputs, counted=(), graph=None):
        self.inputs = _map(torch.empty_like, inputs)
        self.counted = tuple(counted)
        self.batches = 0
        self.live = False
        self.graphs = {}
        cuda = any(x.is_cuda for x in leaves(inputs))
        self._graph = graph if graph is not None or not cuda else self._cuda
        self._stream = self._pool = None

    def fill(self, inputs):
        """Copy a batch's `inputs` (the tree the buffers were made from:
        the same structure, shapes and dtypes) into the buffers, and
        return them. From the shape's second batch on the steps run as
        graphs."""
        for buf, x in zip(leaves(self.inputs), leaves(inputs)):
            buf.copy_(x)
        self.batches += 1
        self.live = self._graph is not None and self.batches > 1
        return self.inputs

    def __call__(self, t, body, carry):
        """The runner: body(carry), or its graph's replay."""
        if not self.live:
            return body(carry)
        ptrs = tuple(x.data_ptr() for x in leaves(carry))
        entry = self.graphs.get(t)
        if entry is None:
            before = self._counts()
            graph = self._graph()
            out = graph.capture(lambda: body(carry))
            after = self._counts()
            added = {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}
            self.graphs[t] = (graph, ptrs, out, added)
            StepGraphs.captures += 1
            obs.count("graph_captures", 1)
        else:
            graph, want, out, added = entry
            if ptrs != want:
                raise RuntimeError("StepGraphs: step %d's inputs are not the "
                                   "tensors its graph was captured on" % t)
            for (i, name), n in added.items():
                if i is None:
                    obs.count(name, n)
                else:
                    obj = self.counted[i]
                    setattr(obj, name, getattr(obj, name) + n)
        graph.replay()
        StepGraphs.replays += 1
        obs.count("graph_replays", 1)
        return out

    def _counts(self):
        """{(i, attribute): value} of the launch counters of counted[i],
        and {(None, name): value} of the open span's counts."""
        out = {(i, name): v for i, obj in enumerate(self.counted)
               for name, v in vars(obj).items()
               if name.startswith("launches")}
        out.update(((None, k), v) for k, v in obs.open_counts().items())
        return out

    def _cuda(self):
        """A CUDA graph on the shape's side stream and pool, made (with
        the libraries' handles and workspaces on that stream) before the
        first capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
            self._warm()
        return CudaGraph(self._stream, self._pool)

    def _warm(self):
        """One small call of each library a step calls, on the side
        stream: cuBLAS's f32 products (the one-column heads, the verb
        rows' tense scores) and the sorts."""
        a = torch.ones((16, 16), device=self._stream.device)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            torch.nn.functional.linear(a, a)
            torch.bmm(a[None], a[None])
            torch.sort(a, dim=1, stable=True)
        torch.cuda.current_stream().wait_stream(self._stream)
