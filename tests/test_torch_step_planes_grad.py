"""XE training's differentiable step products (`ops/step_planes.py::
StepPlanes`, `step_planes_autograd`) on the CPU.

On the card the function's forward is the step products' kernels and its
gradients dA = dC @ W and dW = dC^T @ A nine-plane products of their own
(tests/test_torch_kernels_cuda.py, chip_smoke.py's phase 3g). Here, for
CPU tensors, its forward is the plain version and its gradients plain
products: they are held to `nn.linear` under autograd and to
`torch.autograd.gradcheck` in f64, with A in one to four segments, a bias
and a per-item addend; the lean XE loss through the grouped route
(`train/captioner.py::_xe_route`) keeps the strict route's loss and
gradients; the lean loss keeps the strict route off the card; and every
decode route, teacher forcing and the strict XE step dispatch the same
aten operations as before the route was added (the table in
tests/data/step_route_aten_counts.json, recorded on the tree before it).
"""
import collections
import json
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vsrcic_tpu_torch.models import api
from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                               init_captioner_params)
from vsrcic_tpu_torch.utils import observability as obs

COUNTS = Path(__file__).parent / "data" / "step_route_aten_counts.json"
SEGMENTS = [(7,), (5, 3), (4, 6, 2), (3, 2, 4, 1)]


def _operands(widths, n, rows, add_div, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    segs = [rnd(rows, k) for k in widths]
    add = rnd(-(-rows // add_div) + 1, n) if add_div else None
    return segs, rnd(n, sum(widths)), rnd(n), add


def _reference(segs, w, b, add, add_div):
    out = torch.nn.functional.linear(torch.cat(segs, 1), w, b)
    if add is not None:
        out = out + add[torch.arange(out.shape[0]) // add_div]
    return out


@pytest.mark.parametrize("widths", SEGMENTS)
@pytest.mark.parametrize("add_div", [0, 1, 3])
def test_plain_op_is_nn_linear_under_autograd(widths, add_div):
    """Forward and the gradients of every segment, W, the bias and the
    addend (each item's rows summed, one spare item row at zero) equal
    nn.linear's under autograd, in f32 within rounding."""
    from vsrcic_tpu_torch.ops import step_planes as sp
    segs, w, b, add = _operands(widths, 9, 11, add_div, torch.float32)
    leaves = segs + [w, b] + ([add] if add is not None else [])
    for t in leaves:
        t.requires_grad_(True)
    dc = torch.randn((11, 9), generator=torch.Generator().manual_seed(1))
    got = sp.step_planes_autograd(segs, sp.step_grad_weights(w, b), add,
                                  add_div or 1)
    want = _reference(segs, w, b, add, add_div or 1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g_got = torch.autograd.grad(got, leaves, dc)
    g_want = torch.autograd.grad(want, leaves, dc)
    for x, y in zip(g_got, g_want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("widths,add_div", [((7,), 0), ((4, 6, 2), 1),
                                            ((3, 2, 4, 1), 3)])
def test_gradcheck_f64(widths, add_div):
    """torch.autograd.gradcheck of the function's hand-written backward in
    f64 (the plain products keep the operands' dtype), zero bias made by
    step_grad_weights too."""
    from vsrcic_tpu_torch.ops import step_planes as sp
    segs, w, b, add = _operands(widths, 5, 7, add_div, torch.float64, 2)
    leaves = segs + [w, b] + ([add] if add is not None else [])
    for t in leaves:
        t.requires_grad_(True)
    k = len(segs)

    def f(*xs):
        sw = sp.step_grad_weights(xs[k], xs[k + 1])
        return sp.step_planes_autograd(list(xs[:k]), sw,
                                       xs[k + 2] if add is not None else None,
                                       add_div or 1)
    assert torch.autograd.gradcheck(f, tuple(leaves))
    # a segment that needs no gradient gets none; no bias: zeros
    sw = sp.step_grad_weights(w)
    assert torch.equal(sw.bias, torch.zeros(5, dtype=torch.float64))
    out = sp.step_planes_autograd([segs[0].detach()] + segs[1:], sw)
    grads = torch.autograd.grad(out.sum(), segs[1:] + [w])
    assert all(g is not None for g in grads)


def _tiny_xe():
    cfg = CaptionerConfig(seq_len=5, vocab_size=30, det_feat_size=24,
                          input_encoding_size=12, rnn_size=16, att_size=8)
    g = torch.Generator().manual_seed(0)
    params = init_captioner_params(g, cfg)
    for leaf in params.values():
        for name, t in leaf.items():
            if "bias" in name:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    b, t_len, n, m = 6, cfg.seq_len, 7, 4
    caps = torch.randint(4, 30, (b, t_len), generator=g)
    caps[:, 0] = cfg.bos_idx
    return cfg, params, (torch.randn((b, n, 24), generator=g), caps,
                         torch.randint(-1, n, (b, t_len, m), generator=g),
                         torch.randint(-1, 2, (b, t_len), generator=g))


def _xe_loss_and_grads(cfg, params, batch):
    from vsrcic_tpu_torch.train.captioner import xe_loss_fn
    from vsrcic_tpu_torch.train.common import value_and_grad
    from vsrcic_tpu_torch.utils.params import flatten
    obs.clear()
    (loss, parts), grads = value_and_grad(xe_loss_fn, params, cfg, *batch,
                                          has_aux=True)
    return (loss,) + parts, flatten(grads), obs.summary()


def test_xe_route_keeps_the_strict_loss_and_gradients(monkeypatch):
    """The lean XE loss through the grouped route (the five groups, the
    word head, att_va and img_y through the function) against the strict
    route: losses and every leaf's gradient within 1e-5, relative; the
    function called 7 times a step and once for img_y, its products
    counted on train.forward and train.backward (each step recomputed:
    7 more; dA for 6 products a step, not att_va's or img_y's, whose A is
    the data; dW for all)."""
    from vsrcic_tpu_torch.train import captioner as tc
    cfg, params, batch = _tiny_xe()
    losses, grads, summ = _xe_loss_and_grads(cfg, params, batch)
    assert "step_products" not in summ["train.forward"]["counts"]
    monkeypatch.setattr(tc, "_on_planes", lambda p: True)
    got_losses, got_grads, got_summ = _xe_loss_and_grads(cfg, params, batch)
    for a, b in zip(got_losses, losses):
        assert abs(float(a - b)) <= 1e-5 * abs(float(b))
    for k, want in grads.items():
        gap = float((got_grads[k] - want).norm())
        assert gap <= 1e-5 * float(want.norm()) + 1e-12, k
    t = cfg.seq_len
    assert got_summ["train.forward"]["counts"] == {"step_products": 7 * t + 1}
    assert got_summ["train.backward"]["counts"] == {
        "step_products": 7 * t + 6 * t + 7 * t + 1}


def test_lean_loss_keeps_the_strict_route_off_the_card():
    """The grouped route is taken only on f32 CUDA parameters: CPU and bf16
    parameters keep the strict route."""
    from vsrcic_tpu_torch.models.captioner import STRICT, Statics
    from vsrcic_tpu_torch.train import captioner as tc
    cfg, params, (det, *_) = _tiny_xe()
    statics = Statics(det.mean(1), None, None, None, None)
    for p in (params, {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
                       for k, v in params.items()}):
        assert not tc._on_planes(p)
        assert tc._xe_route(p, cfg, statics) == (statics, STRICT)


# ---------------------------------------------------------------------------
# the aten operations of every other route, as before the grouped XE route
# ---------------------------------------------------------------------------

PATHS = ("strict_beam", "candidates_plain", "candidates_kernel",
         "dense_beam", "fused_plain", "decode_bf16", "greedy", "sample",
         "teacher_forcing", "xe_strict")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.name()] += 1
        return func(*args, **(kwargs or {}))


def _captioner(use_vocab_topk, **kw):
    cfg = CaptionerConfig(seq_len=6, vocab_size=40, det_feat_size=24,
                          input_encoding_size=12, rnn_size=16, att_size=8)
    return api.ControllableCaptioner(
        cfg, seed=1, verb_2_vob_all={str(i): [5 + i, 20 + i]
                                     for i in range(1, 6)},
        use_vocab_topk=use_vocab_topk, device="cpu", **kw)


def aten_counts(path):
    """{aten operation: calls} of one route on a tiny captioner, made and
    run once before the counted run."""
    g = torch.Generator().manual_seed(0)
    det = torch.randn((3, 7, 24), generator=g)
    groups = torch.randn((3, 4, 5, 24), generator=g)
    verb_list = torch.tensor([[-1, 2, -1, -1], [1, -1, -1, 3], [-1] * 4])
    caps = torch.randint(0, 40, (3, 6), generator=g)
    beam_v = ("beam_search_v", (det, groups, verb_list),
              dict(eos_word=3, beam_size=3))
    runs = {
        "strict_beam": ((False,), {}, beam_v),
        "candidates_plain": (("plain",), {}, beam_v),
        "candidates_kernel": ((True,), {}, beam_v),
        "dense_beam": ((True,), {}, ("beam_search", (det, groups),
                                     dict(eos_word=3, beam_size=3))),
        "fused_plain": (("plain",), dict(use_fused_attention="plain"),
                        beam_v),
        "decode_bf16": ((True,), dict(decode_dtype=torch.bfloat16), beam_v),
        "greedy": ((True,), {}, ("test", (det, groups), {})),
        "sample": ((True,), {}, ("sample_rl", (det, groups), {})),
        "teacher_forcing": ((True,), {}, ("forward", (
            det, caps, groups[:, :1].expand(-1, 6, -1, -1)), {})),
    }
    if path == "xe_strict":
        cfg, params, batch = _tiny_xe()
        _xe_loss_and_grads(cfg, params, batch)
        with _Count() as mode:
            _xe_loss_and_grads(cfg, params, batch)
        return dict(mode.counts)
    a, kw, (method, args, call_kw) = runs[path]
    cap = _captioner(*a, **kw)
    for counted in (False, True):
        if method == "sample_rl":
            args = (det, groups, torch.Generator().manual_seed(0))
        with (_Count() if counted else obs.span("warm-up")) as mode:
            getattr(cap, method)(*args, **call_kw)
    return dict(mode.counts)


@pytest.mark.parametrize("path", PATHS)
def test_other_routes_dispatch_what_they_did(path):
    assert aten_counts(path) == json.loads(COUNTS.read_text())[path]
