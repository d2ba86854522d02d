"""Kimi Delta Attention (the KDA layers of Kimi-Linear-48B-A3B,
`models/kimi_linear.py`): the layer's recurrence and the elementwise work
around it, each a hand-written kernel on the card.

The recurrence: per sequence, head and position, over a state S of D x D
(key by value) in f32,

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

Around it, two kernels in `csrc/kda.cu` take the layer's elementwise work,
which as PyTorch operations makes ~25 passes a call over f32 copies:
`conv_qkv` (`short_conv_kernel`), the input stage from in_proj's rows to
the recurrence's q, k, v, g and beta (the causal conv4, SiLU, the L2
norms, the decay and beta gates; at decode the rows' windows read by
parent and written in place), and `gated_norm` (`gated_norm_kernel`), the
output stage from the recurrence's o to o_proj's input. They replace no
TPU kernel either. Bytes bound both (the source's note says how each
design meets that). Their plain versions are those PyTorch operations;
the wrappers run them for CPU tensors, launch for CUDA tensors (heads of
128, bf16 or f32 storage) and count their launches, and never fall
back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vsrcic_tpu_torch.ops import _build

HEAD_DIM = 128        # the kernel's key and value width (csrc/kda.cu kD)
MAX_GROUP = 8         # sequences a CTA holds (kMaxGroup, kConvRows)
L2_EPS = 1e-6         # under the root of the q and k norms (FLA's l2norm)


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


# ---------------------------------------------------------------------------
# the input stage: conv4, SiLU, L2 norms, decay and beta gates
# ---------------------------------------------------------------------------

def short_conv(qkv, w):
    """The causal depthwise convolutions of prefixes whose real tokens
    lead, qkv (P, N, C), weights w (C, K): SiLU of the f32 sums."""
    n, kk = qkv.shape[1], w.shape[1]
    xp = F.pad(qkv, (0, 0, kk - 1, 0)).float()
    w = w.float()
    y = xp[:, :n] * w[:, 0]
    for j in range(1, kk):
        y.addcmul_(xp[:, j:j + n], w[:, j])
    return F.silu(y)


def conv_step(qkv, conv, parent, w):
    """One decode position of the convolutions: rows' inputs qkv (R, C)
    after their parents' last K - 1 inputs (conv (R', K - 1, C), gathered
    by `parent`); the rows' own windows written into `conv` in place.
    Returns SiLU of the f32 sums (R, C)."""
    window = torch.cat([conv.index_select(0, parent), qkv[:, None]], 1)
    conv.copy_(window[:, 1:])
    return F.silu((window.float() * w.T.float()).sum(1))


def qk_norms(y, heads):
    """The convolutions' outputs (..., 3 x heads x D) f32 -> q, k, v (...,
    heads, D), q and k L2-normed per head, q scaled by D^-1/2."""
    d = y.shape[-1] // (3 * heads)
    q, k, v = (t.unflatten(-1, (heads, d)) for t in y.chunk(3, -1))

    def l2(t):
        return t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + L2_EPS)
    return l2(q) * d ** -0.5, l2(k), v.contiguous()


def conv_qkv_plain(proj, f, rate, dt_bias, w, conv, parent=None, group=1,
                   lengths=None, rows_out=None):
    """Plain version (see `conv_qkv`): `short_conv` or `conv_step`, then
    `qk_norms` and the gates; `group` is the kernel's and changes nothing
    here."""
    h = rate.shape[0]
    c, kk = w.shape
    qkv = proj[..., :c]
    if parent is not None:
        y = conv_step(qkv[:, 0], conv, parent, w)[:, None]
    else:
        idx = lengths[:, None].long() + torch.arange(1 - kk, 0,
                                                     device=proj.device)
        last = qkv.gather(1, idx.clamp_min(0)[..., None].expand(-1, -1, c))
        conv[rows_out.long()] = torch.where((idx >= 0)[..., None], last, 0.0)
        y = short_conv(qkv, w)
    q, k, v = qk_norms(y, h)
    d = q.shape[-1]
    g = -rate[:, None] * F.softplus(f.float().unflatten(-1, (h, d))
                                    + dt_bias.float().view(h, d))
    beta = torch.sigmoid(proj[..., -h:].float()).contiguous()
    if parent is None:     # positions past the real tokens: zeros
        live = (torch.arange(proj.shape[1], device=proj.device)[None]
                < lengths[:, None])
        q, k, v, g = (torch.where(live[..., None, None], t, 0.0)
                      for t in (q, k, v, g))
        beta = torch.where(live[..., None], beta, 0.0)
    return q, k, v, g, beta


def conv_qkv(proj, f, rate, dt_bias, w, conv, parent=None, group=1,
             lengths=None, rows_out=None):
    """KDA's input stage over S sequences of T positions and H heads of D.

    proj (S, T, P): in_proj's rows, the pre-conv q, k, v in columns [0, 3
    H D) and beta's pre-sigmoid b in the last H; f (S, T, H D) = W_fb W_fa
    x; rate (H,) f32, the heads' decay rates A = exp(A_log); dt_bias (H D,)
    f32; w (3 H D, K) the depthwise conv's weights; conv (R, K - 1, 3 H D)
    the rows' windows of pre-conv inputs, in proj's dtype, updated in
    place. Decode (`parent` (S,) int32, T = 1): row s convolves
    conv[parent[s]]'s inputs and its own, and leaves its window in conv[s];
    rows g * group .. g * group + group - 1 are one group, whose parents
    are rows of the group. Prefill (`lengths`, `rows_out` (S,) int32): the
    first lengths[s] positions of sequence s are real, convolved after
    zeros; conv[rows_out[s]] receives its last K - 1 real inputs (zeros
    where fewer). Every sum in f32: the conv's taps in order, SiLU; q and k
    L2-normed per head (eps 1e-6 under the root), q scaled by D^-1/2; g =
    -A softplus(f + dt_bias), beta = sigmoid(b).

    Returns q, k, v, g (S, T, H, D) and beta (S, T, H), f32, zeros past a
    prefix's real positions. Plain version for CPU tensors; the CUDA
    kernel for CUDA tensors (D = HEAD_DIM, K = 4, proj, f, w and conv one
    dtype of bf16 and f32, every tensor contiguous, P even, 1 <= group <=
    MAX_GROUP dividing S)."""
    if proj.device.type == "cpu":
        return conv_qkv_plain(proj, f, rate, dt_bias, w, conv, parent, group,
                              lengths, rows_out)
    if proj.device.type != "cuda":
        raise ValueError("conv_qkv: unsupported device %s" % proj.device)
    s_, t_, p = proj.shape
    h = rate.shape[0]
    c = 3 * h * HEAD_DIM
    dev, f32, i32, dt = proj.device, torch.float32, torch.int32, proj.dtype
    if dt not in (torch.bfloat16, f32):
        raise ValueError("conv_qkv: the kernel takes bf16 or f32, got %s"
                         % dt)
    if p < c + h or p % 2:
        raise ValueError("conv_qkv: proj's %d columns must be even and hold "
                         "q, k, v (%d) and b (%d)" % (p, c, h))
    for name, t, shape, dtype in (
            ("proj", proj, (s_, t_, p), dt), ("f", f, (s_, t_, c // 3), dt),
            ("rate", rate, (h,), f32), ("dt_bias", dt_bias, (c // 3,), f32),
            ("w", w, (c, 4), dt),
            ("conv", conv, (conv.shape[0], 3, c), dt)):
        _build.check_tensor(t, name, shape, dtype, dev)
    if parent is not None:
        if t_ != 1 or not 1 <= group <= MAX_GROUP or s_ % group:
            raise ValueError("conv_qkv: decode takes T = 1 and a group in "
                             "[1, %d] dividing S = %d; got T = %d, group %d"
                             % (MAX_GROUP, s_, t_, group))
        if conv.shape[0] < s_:
            raise ValueError("conv_qkv: %d window rows for %d rows"
                             % (conv.shape[0], s_))
        _build.check_tensor(parent, "parent", (s_,), i32, dev)
    else:
        if lengths is None or rows_out is None:
            raise ValueError("conv_qkv: prefill takes lengths and rows_out")
        _build.check_tensor(lengths, "lengths", (s_,), i32, dev)
        _build.check_tensor(rows_out, "rows_out", (s_,), i32, dev)
    out = torch.empty((4, s_, t_, h, HEAD_DIM), dtype=f32, device=dev)
    beta = torch.empty((s_, t_, h), dtype=f32, device=dev)
    if s_ and t_ and h:
        _conv_launch(_build.library(), proj, f, rate, dt_bias, w, conv,
                     parent, group, lengths, rows_out, out, beta)
        conv_qkv.launches += 1
    return (*out.unbind(0), beta)


conv_qkv.launches = 0


def _conv_launch(lib, proj, f, rate, dt_bias, w, conv, parent, group,
                 lengths, rows_out, out, beta):
    """Launch `short_conv_kernel` of library `lib` on checked operands into
    the caller's `out` (4, S, T, H, D) (q, k, v, g) and `beta`
    (uncounted: the wrapper counts; tools/memcheck.py passes guarded
    buffers). Raises if the card refuses the launch."""
    s_, t_, p = proj.shape
    ptr = [t.data_ptr() for t in (proj, f, rate, dt_bias, w, conv)]
    ptr += [0 if t is None else t.data_ptr()
            for t in (parent, lengths, rows_out)]
    ptr += [t.data_ptr() for t in out] + [beta.data_ptr()]
    err = lib.vsrcic_short_conv(*ptr, s_, t_, rate.shape[0], conv.shape[0],
                                p, group, int(proj.dtype == torch.bfloat16),
                                _build.stream(proj.device))
    _build.check(err, "conv_qkv", lib)


# ---------------------------------------------------------------------------
# the output stage: the gated RMSNorm
# ---------------------------------------------------------------------------

def gated_norm_plain(o, gate, weight, eps):
    """Plain version (see `gated_norm`)."""
    o = F.rms_norm(o, (o.shape[-1],), weight.float(), eps)
    o = o * torch.sigmoid(gate.float().unflatten(-1, o.shape[-2:]))
    return o.flatten(-2).to(gate.dtype)


def gated_norm(o, gate, weight, eps):
    """KDA's output stage: the recurrence's o (..., H, D) f32 RMSNorm'd per
    head in f32 (weight (D,), eps), times sigmoid(gate) in f32, gate (...,
    H D); returns (..., H D) in the gate's dtype (o_proj's input). Plain
    version for CPU tensors; the CUDA kernel for CUDA tensors (D =
    HEAD_DIM, gate and weight one dtype of bf16 and f32, contiguous)."""
    if o.device.type == "cpu":
        return gated_norm_plain(o, gate, weight, eps)
    if o.device.type != "cuda":
        raise ValueError("gated_norm: unsupported device %s" % o.device)
    dt, dev = gate.dtype, o.device
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError("gated_norm: the kernel takes bf16 or f32, got %s"
                         % dt)
    lead, d = o.shape[:-1], o.shape[-1]
    if d != HEAD_DIM:
        raise ValueError("gated_norm: the kernel takes heads of %d, got o "
                         "%s" % (HEAD_DIM, tuple(o.shape)))
    _build.check_tensor(o, "o", tuple(o.shape), torch.float32, dev)
    _build.check_tensor(gate, "gate", tuple(lead[:-1]) + (lead[-1] * d,), dt,
                        dev)
    _build.check_tensor(weight, "weight", (d,), dt, dev)
    out = torch.empty_like(gate)
    if out.numel():
        _norm_launch(_build.library(), o, gate, weight, eps, out)
        gated_norm.launches += 1
    return out


gated_norm.launches = 0


def _norm_launch(lib, o, gate, weight, eps, out):
    """Launch `gated_norm_kernel` of library `lib` on checked operands into
    the caller's `out` (uncounted, as `_conv_launch`)."""
    err = lib.vsrcic_gated_norm(o.data_ptr(), gate.data_ptr(),
                                weight.data_ptr(), out.data_ptr(),
                                o.numel() // o.shape[-1], float(eps),
                                int(gate.dtype == torch.bfloat16),
                                _build.stream(o.device))
    _build.check(err, "gated_norm", lib)
