"""Kimi Delta Attention's recurrence (the KDA layers of Kimi-Linear-48B-A3B,
`models/kimi_linear.py`): per sequence, head and position, over a state S
of D x D (key by value) in f32,

    S <- (I - beta k k^T) Diag(alpha) S + beta k v^T,    o = S^T q,

alpha = exp(g) the decay per key channel. A position that is not valid
(padding) neither decays nor updates the state, and outputs 0.

Replaces no TPU kernel: the JAX package has no linear-attention layer. It
was added for the Kimi-Linear decoder, whose recurrence is two thirds of a
decode step's least time at the cell's 640 rows (PERF.md section 6).

What bounds it on the H100: at decode, bytes. Each row reads its parent's
state and writes its own, 2 x 64 KB a head, 2.7 GB a layer at 640 rows,
against ~7 D^2 f32 operations a row and head (one operation a byte). At
prefill the state stays on chip across a job's positions, read never and
written once; the ~7 D^2 operations a position on the CUDA cores (67
TFLOP/s in f32) bound it.

Kernel design (`csrc/kda.cu`, `kda_recurrence_kernel`): each value column
of S evolves on its own given (k, beta, alpha), so a lane owns one column,
its D values in registers, and a warp 32 columns of one sequence and head.
A CTA holds a group of G sequences (the beams of one job at decode, one
job at prefill) for one head and 32 columns: every lane first reads its
sequence's starting column (its parent's row in the state, or zeros),
the CTA synchronises, and only then does any lane write, so a row can
read its parent and write its own state in place within the group, and
the state is held once (no copy for the beam's reorder). Each position's
q, k and decay go through the warp's shared vectors (read by every lane,
broadcast); the position loop runs inside the kernel, so a prefix's
positions keep the state in registers. Sums run in key order in f32.

`kda_recurrence_plain` is the plain PyTorch version: the starting states
gathered into a copy, the positions stepped in order, the final states
scattered. The wrapper `kda_recurrence` runs it for CPU tensors and
launches the kernel for CUDA tensors (head width 128 there), counting its
launches; it never falls back.
"""
from __future__ import annotations

import torch

from vsrcic_tpu_torch.ops import _build

HEAD_DIM = 128        # the kernel's key and value width (csrc/kda.cu kD)
MAX_GROUP = 8         # sequences a CTA holds (kMaxGroup)


def kda_step(s, q, k, v, alpha, beta):
    """One position on states s (..., D, Dv): (the new states, o (...,
    Dv)); q, k, alpha (..., D), v (..., Dv), beta (...)."""
    s = s * alpha[..., None]
    u = torch.einsum("...d,...dv->...v", k, s)
    s = s + k[..., None] * (beta[..., None] * (v - u))[..., None, :]
    return s, torch.einsum("...d,...dv->...v", q, s)


def kda_recurrence_plain(q, k, v, g, beta, state, rows_in, rows_out,
                         valid=None, group=1):
    """Plain version (see `kda_recurrence`); `group` is the kernel's and
    changes nothing here."""
    live_in = (rows_in >= 0)[:, None, None, None]
    s = torch.where(live_in, state[rows_in.long().clamp_min(0)], 0.0)
    out = torch.zeros_like(v)
    for t in range(q.shape[1]):
        s_new, o = kda_step(s, q[:, t], k[:, t], v[:, t], torch.exp(g[:, t]),
                            beta[:, t])
        if valid is None:
            s, out[:, t] = s_new, o
        else:
            live = valid[:, t].bool()
            s = torch.where(live[:, None, None, None], s_new, s)
            out[:, t] = torch.where(live[:, None, None], o, 0.0)
    state[rows_out.long()] = s
    return out


def kda_recurrence(q, k, v, g, beta, state, rows_in, rows_out, valid=None,
                   group=1):
    """KDA's recurrence over S sequences of T positions and H heads.

    q, k, g (S, T, H, D) and v (S, T, H, Dv) f32; beta (S, T, H) f32;
    state (R, H, D, Dv) f32, updated in place: sequence s starts from
    state[rows_in[s]] (rows_in[s] < 0: zeros) and leaves its final state
    in state[rows_out[s]]; rows_in, rows_out (S,) int32; valid (S, T)
    uint8 or None (every position). Sequences g * group .. g * group +
    group - 1 are one group: the rows a group reads must be rows that it
    writes or that no group writes (a beam's parents within its job).
    Returns o (S, T, H, Dv) f32, 0 at positions not valid.

    Plain version for CPU tensors; the CUDA kernel for CUDA tensors (D =
    Dv = HEAD_DIM, 1 <= group <= MAX_GROUP, S a multiple of group, every
    tensor contiguous)."""
    if q.device.type == "cpu":
        return kda_recurrence_plain(q, k, v, g, beta, state, rows_in,
                                    rows_out, valid, group)
    if q.device.type != "cuda":
        raise ValueError("kda_recurrence: unsupported device %s" % q.device)
    s_, t_, h, d = q.shape
    r = state.shape[0]
    if d != HEAD_DIM or v.shape[-1] != HEAD_DIM:
        raise ValueError("kda_recurrence: the kernel takes heads of %d, got "
                         "q %s, v %s" % (HEAD_DIM, tuple(q.shape),
                                         tuple(v.shape)))
    if not 1 <= group <= MAX_GROUP or s_ % group:
        raise ValueError("kda_recurrence: group %d must lie in [1, %d] and "
                         "divide S = %d" % (group, MAX_GROUP, s_))
    dev, f32, i32 = q.device, torch.float32, torch.int32
    for name, t, shape in (("q", q, (s_, t_, h, d)), ("k", k, (s_, t_, h, d)),
                           ("v", v, (s_, t_, h, d)), ("g", g, (s_, t_, h, d)),
                           ("beta", beta, (s_, t_, h)),
                           ("state", state, (r, h, d, d))):
        _build.check_tensor(t, name, shape, f32, dev)
    _build.check_tensor(rows_in, "rows_in", (s_,), i32, dev)
    _build.check_tensor(rows_out, "rows_out", (s_,), i32, dev)
    if valid is not None:
        _build.check_tensor(valid, "valid", (s_, t_), torch.uint8, dev)
    out = torch.empty_like(v)
    if s_ and t_ and h:
        _launch(_build.library(), q, k, v, g, beta, valid, rows_in,
                rows_out, state, out, group)
        kda_recurrence.launches += 1
    return out


kda_recurrence.launches = 0


def _launch(lib, q, k, v, g, beta, valid, rows_in, rows_out, state, out,
            group):
    """Launch the kernel of library `lib` (`_build.library()`, or the
    checked build) on checked operands, into the caller's `out`
    (uncounted: the wrapper counts; tools/memcheck.py passes guarded
    buffers). Raises if the card refuses the launch."""
    s_, t_, h, _ = q.shape
    err = lib.vsrcic_kda(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         g.data_ptr(), beta.data_ptr(),
                         0 if valid is None else valid.data_ptr(),
                         rows_in.data_ptr(), rows_out.data_ptr(),
                         state.data_ptr(), out.data_ptr(), s_, t_, h,
                         state.shape[0], group, _build.stream(q.device))
    _build.check(err, "kda_recurrence", lib)
