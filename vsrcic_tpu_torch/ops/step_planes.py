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
    up to 8 (None on the CPU)."""
    w: torch.Tensor
    bias: torch.Tensor
    planes: Optional[torch.Tensor]


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
        torch.cuda.current_stream(planes.device).cuda_stream),
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
    r // add_div of `add` (items, N) at row r where it is given, in f32."""
    a = torch.cat([s.float() for s in segments], 1)
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
    dev = segments[0].device
    if dev.type == "cpu":
        return step_planes_plain(segments, sw, add, add_div)
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
    k = sum(s.shape[1] for s in segments)
    n = sw.w.shape[0]
    _build.check_tensor(sw.w, "w", (n, k), f32, dev)
    _build.check_tensor(sw.bias, "bias", (n,), f32, dev)
    _build.check_tensor(sw.planes, "planes", (vt.SPLIT_PLANES, k, n + -n % 8),
                        torch.bfloat16, dev)
    if add is not None:
        _build.check_tensor(add, "add", (add.shape[0], n), f32, dev)
        if add_div < 1 or add.shape[0] * add_div < rows:
            raise ValueError("step_planes: %d addend rows, each for %d rows, "
                             "for %d rows" % (add.shape[0], add_div, rows))
    out = torch.empty((rows, n), dtype=f32, device=dev)
    if rows == 0 or n == 0:
        return out
    sms = _build.sm_count(dev)
    plan = step_launch_plan(rows, k, n, sms)
    if plan.cluster > 1:
        plan = step_launch_plan(rows, k, n, sms, vt.resident_clusters(
            dev, plan.stages, plan.planes, plan.w_planes))
    lib = _build.library()
    a_planes = torch.empty((vt.SPLIT_PLANES, rows, k + -k % 8),
                           dtype=torch.bfloat16, device=dev)
    _split_launch(lib, segments, a_planes)
    _launch(lib, plan, a_planes, sw.planes, sw.bias, add, add_div, out)
    step_planes.launches += 1
    return out


step_planes.launches = 0


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
        torch.cuda.current_stream(out.device).cuda_stream), "step_planes",
        lib)
