"""Sinkhorn normalization: exp(x / tau), then alternating column and row
normalization of each (n x n) matrix.

Replaces the TPU kernel `scripts/ab_sinkhorn.py::sinkhorn_normalize_pallas`
(one matrix per grid step, the whole iteration loop on-chip), which computes
the same function as `vsrcic_tpu/models/sinkhorn.py::sinkhorn_normalize`:

    v = exp(x / tau)
    n_iters times:  v = v / (EPS + colsum(v));  v = v / (EPS + rowsum(v))

with EPS = 1e-7 added to each sum before the division, as JAX does.

What bounds it on the H100: device-memory bytes, each matrix read once and
written once (4 n^2 bytes each way), against ~(1 + 4 n_iters) operations
per element; at the eval pipeline's S = 1536 matrices of n = 10 that is
1.23 MB, 0.37 us at 3.35 TB/s, so one call costs its launch latency. The
plain version makes about 4 n_iters + 2 launches; the kernel makes one.

Kernel design (`csrc/sinkhorn.cu`): for n <= 32 one warp per matrix, eight
matrices per block, the matrix in shared memory at an odd row stride (no
bank conflicts): lane c sums and divides column c, then after a
`__syncwarp` lane r sums and divides row r. For 32 < n <= MAX_N one block
per matrix, one thread per column, then per row. All sums run in index
order in f32; x / tau is a true division, not a product with 1 / tau.

`sinkhorn_normalize_plain` is the plain PyTorch version. The wrapper
`sinkhorn_normalize` runs it for CPU tensors and launches the kernel for
CUDA tensors; it never falls back.
"""
from __future__ import annotations

import torch

from vsrcic_tpu_torch.ops import _build

EPS = 10e-8  # ref sinkhorn_network.py:34-35

# the largest n whose matrix fits one block's shared memory (232,448 bytes)
# at the kernel's row stride n | 1
MAX_N = 241


def sinkhorn_normalize_plain(x, n_iters: int, tau: float):
    """Plain version. x: (S, n, n) f32 -> (S, n, n) f32.

    tau is divided as a tensor: CUDA's division by a Python scalar multiplies
    by its reciprocal, which JAX does not. The tensor is filled on the
    device (a copy from the host would wait for the stream)."""
    v = torch.exp(x / torch.full((), tau, dtype=x.dtype, device=x.device))
    for _ in range(n_iters):
        v = v / (EPS + v.sum(-2, keepdim=True))
        v = v / (EPS + v.sum(-1, keepdim=True))
    return v


def sinkhorn_normalize(x, n_iters: int, tau: float):
    """Plain version for CPU tensors; the CUDA kernel for CUDA tensors.
    x: (S, n, n) contiguous f32 with n <= MAX_N; any S."""
    if x.device.type == "cpu":
        return sinkhorn_normalize_plain(x, n_iters, tau)
    if x.device.type != "cuda":
        raise ValueError("sinkhorn_normalize: unsupported device %s"
                         % x.device)
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError("sinkhorn_normalize: x must be (S, n, n), got %s"
                         % (tuple(x.shape),))
    s, n, _ = x.shape
    if n > MAX_N:
        raise ValueError("sinkhorn_normalize: n=%d exceeds the kernel's limit "
                         "of %d (one matrix per block's shared memory)"
                         % (n, MAX_N))
    _build.check_tensor(x, "x", (s, n, n), torch.float32, x.device)
    out = torch.empty_like(x)
    if s == 0 or n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vsrcic_sinkhorn(x.data_ptr(), s, n, int(n_iters), tau, EPS,
                              out.data_ptr(), stream)
    _build.check(err, "sinkhorn_normalize")
    sinkhorn_normalize.launches += 1
    return out


sinkhorn_normalize.launches = 0
