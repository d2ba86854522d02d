"""The candidate step's f32 products on the tensor cores: out = A @ W^T +
bias (+ a per-item addend), A given as up to MAX_SEGMENTS f32 segments side
by side along its depth, so that no caller concatenates them.

JAX leaves these products to XLA's dot; the port's strict step keeps them
as cuBLAS f32 products (`nn.linear`). The fast path's candidate step
(`models/captioner.py::captioner_step_v_topk`, which the facade builds with
`use_vocab_topk` and without the fused attention op) groups its products by
their input (`derive_step_product_groups`) and runs each group here. Every
f32 operand is taken as its three exact bf16 planes (hi + mid + lo, the
split of `vocab_topk.split_bf16x3_plain`); a bf16 x bf16 product is exact
in f32, so the nine plane products summed in f32 are the f32 product, up to
the order of the f32 sums. On the card W^T's planes are made once a decode
(`step_weights`), A's on every call (`step_planes_split_kernel`), and the
nine products run on `step_planes_kernel`: the vocab head's "split9"
mainloop under a store epilogue that adds the bias and the addend
(csrc/vocab_topk.cu says why each 64-deep stage goes into fresh
accumulators).

`step_planes_plain` is the plain version, the f32 product of the
concatenated segments. The wrapper `step_planes` runs it for CPU tensors
and the kernels for CUDA tensors, never falling back; it counts its product
launches in `step_planes.launches`, and every call, on any device, as
`step_products` on the recorder's innermost open span (`beam.step` in a
beam).

XE training's step (`train/captioner.py::_xe_loss_compact` on f32 CUDA
parameters) takes its products through `step_planes_autograd`, the
autograd function `StepPlanes` over the same forward: on the card the
forward is `step_planes`' launches and keeps A's planes for the backward;
dA = dC @ W and dW = dC^T @ A run on `step_planes_grad_kernel` (the same
mainloop, the sums stored alone), dA on dC's planes and W's untransposed
planes (3, N, K8), dW on the planes of dC^T (`step_planes_split_t_kernel`)
and A's kept planes; the bias's gradient is dC summed over the rows, the
addend's over each item's rows. Every sum has one fixed order, so a
recomputed forward (the loss's checkpointed steps) repeats the first bit
for bit. For CPU tensors the function's forward is the plain version and
its gradients plain products in the operands' dtype. The gradient
products count in `step_planes.grad_launches` on the card and, on any
device, as `step_products` on the recorder's innermost open span
(`train.forward` in the forward; `train.backward`, a span shared with
the autograd engine's threads, in the backward and its recomputed
forwards).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from vsrcic_tpu_torch.ops import _build
from vsrcic_tpu_torch.ops import vocab_topk as vt
from vsrcic_tpu_torch.utils import observability as obs

MAX_SEGMENTS = 4   # segments of A (csrc MAX_SEGS)


class StepWeights(NamedTuple):
    """One group's weights: w (N, K) f32 (the plain version reads it), bias
    (N,) f32, and on the card W^T's bf16 planes (3, K, N8), N8 = N rounded
    up to 8 (None on the CPU); for training (`step_grad_weights`) also W's
    own planes (3, N, K8), dA's operand."""
    w: torch.Tensor
    bias: torch.Tensor
    planes: Optional[torch.Tensor]
    w_planes: Optional[torch.Tensor] = None


def step_weights(w, bias=None, with_planes=True) -> StepWeights:
    """A group's weights from w (N, K) and bias (N,) (None: zeros), of any
    float dtype (upcast to f32, exactly); W^T's planes made on the card
    unless `with_planes` is False (the plain version's weights)."""
    w = w.float().contiguous()
    bias = (torch.zeros((w.shape[0],), device=w.device) if bias is None
            else bias.float().contiguous())
    planes = (split_segments([w.t().contiguous()])
              if with_planes and w.device.type == "cuda" else None)
    return StepWeights(w, bias, planes)


def step_grad_weights(w, bias=None) -> StepWeights:
    """A group's weights for `step_planes_autograd`: w (N, K) and bias (N,)
    (None: zeros) f32 as given, so that the gradients reach what they were
    built from, and on the card the planes of their values, W^T's (the
    forward's) and W's (dA's), made and checked once a training step (the
    function's calls check only their own inputs)."""
    if bias is None:
        bias = torch.zeros((w.shape[0],), dtype=w.dtype, device=w.device)
    if w.device.type != "cuda":
        return StepWeights(w, bias, None)
    v = w.detach()
    sw = StepWeights(w, bias, split_segments([v.t().contiguous()]),
                     split_segments([v.contiguous()]))
    _check_weights(sw, w.shape[1], w.device)
    return sw


def split_segments(segments):
    """A = [segments...] (rows, K) as its three bf16 planes (3, rows, K8),
    K8 = K rounded up to 8, columns K.. zero: `split_bf16x3_plain` of the
    concatenation for CPU tensors, `step_planes_split_kernel` for CUDA
    tensors (contiguous f32 segments, at most MAX_SEGMENTS). Uncounted."""
    if segments[0].device.type == "cpu":
        return vt.split_bf16x3_plain(torch.cat(segments, 1))
    rows = segments[0].shape[0]
    k = sum(s.shape[1] for s in segments)
    planes = torch.empty((vt.SPLIT_PLANES, rows, k + -k % 8),
                         dtype=torch.bfloat16, device=segments[0].device)
    _split_launch(_build.library(), segments, planes)
    return planes


def _split_launch(lib, segments, planes):
    """Launch the split pass of library `lib` on checked f32 segments
    (rows >= 1) into the caller's `planes` (tools/memcheck.py passes
    guarded ones). Raises if the card refuses the launch."""
    pad = MAX_SEGMENTS - len(segments)
    _build.check(lib.vsrcic_step_planes_split(
        *[s.data_ptr() for s in segments], *[None] * pad,
        *[s.shape[1] for s in segments], *[0] * pad, segments[0].shape[0],
        planes.data_ptr(),
        _build.stream(planes.device)),
        "step_planes (split)", lib)


@functools.lru_cache(maxsize=256)
def step_launch_plan(rows, k, n, sms=vt.SMS, resident=None):
    """The product kernel's launch for A (rows, K) @ W^T (K, N) on a card of
    `sms` SMs holding `resident` clusters of 2 at once (default sms // 2):
    the "split9" route's plan (three planes of each operand, 128 x 128
    tiles, SPLIT9_STAGES ring slots, persistent clusters of 2 along N that
    multicast A's planes, or of one CTA where N is one tile). Raises
    ValueError on an empty shape."""
    if min(rows, k, n, sms) < 1 or (resident is not None and resident < 1):
        raise ValueError("step launch plan: rows %s, K %s, N %s, SMs %s, "
                         "resident clusters %s" % (rows, k, n, sms, resident))
    return vt._tma_plan("step_planes", rows, n, sms, vt.SPLIT9_STAGES,
                        resident, vt.SPLIT_PLANES, vt.SPLIT_PLANES)


def step_planes_plain(segments, sw: StepWeights, add=None, add_div=1):
    """Plain version: [segments] (rows, K) @ sw.w^T + sw.bias, plus row
    r // add_div of `add` (items, N) at row r where it is given, in sw.w's
    dtype (f32; f64 in the gradient checks)."""
    a = torch.cat([s.to(sw.w.dtype) for s in segments], 1)
    out = a @ sw.w.T + sw.bias
    if add is not None:
        item = torch.arange(out.shape[0], device=out.device) // add_div
        out = out + add[item]
    return out


def step_planes(segments, sw: StepWeights, add=None, add_div=1):
    """Plain version for CPU tensors; the kernels for CUDA tensors (see the
    module's note). segments: 1 to MAX_SEGMENTS tensors (rows, k_s) of a
    float dtype (upcast exactly), K = their widths' sum; sw: the group's
    `step_weights` (N, K); add: f32 (items, N) with items * add_div >=
    rows, or None. -> (rows, N) f32."""
    obs.count("step_products", 1)
    if segments[0].device.type == "cpu":
        return step_planes_plain(segments, sw, add, add_div)
    return _forward(segments, sw, add, add_div)[0]


step_planes.launches = 0
step_planes.grad_launches = 0


def _forward(segments, sw: StepWeights, add, add_div):
    """`step_planes` on the card, checked: (out, A's planes (3, rows, K8),
    or None where the output is empty). Counts the product's launch."""
    segments, k = _inputs(segments, sw.w.shape[0], add, add_div)
    _check_weights(sw, k, segments[0].device)
    return _run(segments, sw.planes, sw.bias, add, add_div)


def _inputs(segments, n, add, add_div):
    """(the segments as f32 contiguous tensors, K) of a product with N
    output columns on the card, the segments and the addend checked."""
    dev = segments[0].device
    if dev.type != "cuda":
        raise ValueError("step_planes: unsupported device %s" % dev)
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError("step_planes: %d segments (1 to %d)"
                         % (len(segments), MAX_SEGMENTS))
    f32 = torch.float32
    rows = segments[0].shape[0]
    segments = [s.float().contiguous() for s in segments]
    for i, s in enumerate(segments):
        _build.check_tensor(s, "segment %d" % i, (rows, s.shape[-1]), f32,
                            dev)
    if add is not None:
        _build.check_tensor(add, "add", (add.shape[0], n), f32, dev)
        if add_div < 1 or add.shape[0] * add_div < rows:
            raise ValueError("step_planes: %d addend rows, each for %d rows, "
                             "for %d rows" % (add.shape[0], add_div, rows))
    return segments, sum(s.shape[1] for s in segments)


def _check_weights(sw: StepWeights, k, dev):
    """Raise unless `sw` is a group's weights of depth K on the card `dev`
    as the forward's kernels read them."""
    n = sw.w.shape[0]
    _build.check_tensor(sw.w, "w", (n, k), torch.float32, dev)
    _build.check_tensor(sw.bias, "bias", (n,), torch.float32, dev)
    _build.check_tensor(sw.planes, "planes", (vt.SPLIT_PLANES, k, n + -n % 8),
                        torch.bfloat16, dev)


def _run(segments, planes, bias, add, add_div):
    """The split pass and the product on checked inputs (`_inputs`) and
    weights (`_check_weights`): (out, A's planes, or None where the output
    is empty). Counts the product's launch."""
    dev, rows = segments[0].device, segments[0].shape[0]
    k, n = planes.shape[1], bias.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if rows == 0 or n == 0:
        return out, None
    plan = _plan(dev, rows, k, n)
    lib = _build.library()
    a_planes = torch.empty((vt.SPLIT_PLANES, rows, k + -k % 8),
                           dtype=torch.bfloat16, device=dev)
    _split_launch(lib, segments, a_planes)
    _launch(lib, plan, a_planes, planes, bias, add, add_div, out)
    step_planes.launches += 1
    return out, a_planes


@functools.lru_cache(maxsize=256)
def _plan(dev, rows, k, n):
    """`step_launch_plan` for the card `dev`, its grid capped by the
    clusters of 2 the card holds at once."""
    sms = _build.sm_count(dev)
    plan = step_launch_plan(rows, k, n, sms)
    if plan.cluster > 1:
        plan = step_launch_plan(rows, k, n, sms, vt.resident_clusters(
            dev, plan.stages, plan.planes, plan.w_planes))
    return plan


def _launch(lib, plan, a_planes, w_planes, bias, add, add_div, out):
    """Launch `plan` of library `lib` (`_build.library()`, or the checked
    build) on A's planes (3, rows, K8) and W^T's (3, K, N8) into the
    caller's `out` (rows, N) (tools/memcheck.py passes guarded buffers).
    Uncounted. Raises if the card refuses the launch."""
    rows, n = out.shape
    _build.check(lib.vsrcic_step_planes(
        a_planes.data_ptr(), w_planes.data_ptr(), bias.data_ptr(),
        None if add is None else add.data_ptr(), add_div,
        0 if add is None else add.shape[0], rows, w_planes.shape[1], n,
        w_planes.shape[-1], plan.stages, plan.cluster, plan.grid,
        plan.smem_bytes, out.data_ptr(),
        _build.stream(out.device)), "step_planes",
        lib)


def split_t(x):
    """x (rows, N) f32, contiguous, on the card -> the bf16 planes of x^T
    (3, N, rows8), rows8 = rows rounded up to 8, columns rows.. zero: the
    transposing split pass (`step_planes_split_t_kernel`), uncounted;
    `split_bf16x3_plain(x.t())` bit for bit."""
    rows, n = x.shape
    planes = torch.empty((vt.SPLIT_PLANES, n, rows + -rows % 8),
                         dtype=torch.bfloat16, device=x.device)
    _split_t_launch(_build.library(), x, planes)
    return planes


def _split_t_launch(lib, x, planes):
    """Launch the transposing split pass of library `lib` on a checked x
    (rows, N) into the caller's `planes` (tools/memcheck.py passes guarded
    ones). Raises if the card refuses the launch."""
    _build.check(lib.vsrcic_step_planes_split_t(
        x.data_ptr(), x.shape[0], x.shape[1], planes.data_ptr(),
        _build.stream(x.device)),
        "step_planes (transposing split)", lib)


def _grad_launch(lib, plan, a_planes, b_planes, out):
    """Launch `plan` of library `lib` for a gradient product, out (rows, N)
    f32 = A (rows, K) @ B (K, N), on A's planes (3, rows, K8) and B's (3,
    K, N8), into the caller's `out` (tools/memcheck.py passes guarded
    buffers). Uncounted. Raises if the card refuses the launch."""
    rows, n = out.shape
    _build.check(lib.vsrcic_step_planes_grad(
        a_planes.data_ptr(), b_planes.data_ptr(), rows, b_planes.shape[1],
        n, b_planes.shape[-1], plan.stages, plan.cluster, plan.grid,
        plan.smem_bytes, out.data_ptr(),
        _build.stream(out.device)),
        "step_planes (gradient)", lib)


def _grad_product(a_planes, b_planes, n):
    """A @ B (rows, N) f32 on the card from A's planes (3, rows, K8) and
    B's (3, K, N8): one counted launch of `step_planes_grad_kernel`."""
    rows, k = a_planes.shape[1], b_planes.shape[1]
    out = torch.empty((rows, n), dtype=torch.float32, device=a_planes.device)
    _grad_launch(_build.library(), _plan(out.device, rows, k, n), a_planes,
                 b_planes, out)
    step_planes.grad_launches += 1
    return out


def _per_item(dc, items, add_div):
    """The addend's gradient: dC (rows, N) summed over each item's add_div
    rows, (items, N); rows past dC's count as zeros."""
    rows, n = dc.shape
    if add_div == 1 and items == rows:
        return dc
    dc = torch.cat([dc, dc.new_zeros((items * add_div - rows, n))])
    return dc.view(items, add_div, n).sum(1)


class StepPlanes(torch.autograd.Function):
    """out = [segments] @ w^T + bias (+ the addend's item rows) with its
    gradients (the module's note): `step_planes_autograd` applies it."""

    @staticmethod
    def forward(ctx, planes, w_planes, add_div, w, bias, add, *segments):
        if segments[0].device.type == "cuda":
            # the weights were checked where they were made
            # (`step_grad_weights`)
            out, a = _run(_inputs(segments, w.shape[0], add, add_div)[0],
                          planes, bias, add, add_div)
            b = w_planes
        else:
            out = step_planes_plain(segments, StepWeights(w, bias, None), add,
                                    add_div)
            a, b = torch.cat([s.to(w.dtype) for s in segments], 1), w
        ctx.save_for_backward(a, b)
        ctx.add_div = add_div
        ctx.add_rows = None if add is None else add.shape[0]
        ctx.widths = tuple(s.shape[1] for s in segments)
        return out

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        need_a, need_w = any(need[6:]), need[3]
        k = sum(ctx.widths)
        dc = dc.contiguous()
        da = dw = None
        if dc.device.type == "cuda":
            if need_a:
                da = _grad_product(split_segments([dc]), b, k)
            if need_w:
                dw = _grad_product(split_t(dc), a, k)
        else:
            da = dc @ b if need_a else None
            dw = dc.T @ a if need_w else None
        if need_a or need_w:
            obs.count("step_products", need_a + need_w)
        grads, lo = [], 0
        for i, width in enumerate(ctx.widths):
            grads.append(da[:, lo:lo + width] if need[6 + i] else None)
            lo += width
        return (None, None, None, dw, dc.sum(0) if need[4] else None,
                _per_item(dc, ctx.add_rows, ctx.add_div) if need[5]
                else None, *grads)


def step_planes_autograd(segments, sw: StepWeights, add=None, add_div=1):
    """`step_planes` under autograd (`StepPlanes`): gradients to the
    segments, sw.w, sw.bias and `add` wherever they require one. sw: the
    group's `step_grad_weights` (on the card both planes); the rest as
    `step_planes` takes it. Counts the call as `step_products`."""
    obs.count("step_products", 1)
    return StepPlanes.apply(sw.planes, sw.w_planes, add_div, sw.w, sw.bias,
                            add, *segments)
