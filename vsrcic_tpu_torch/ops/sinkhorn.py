"""Sinkhorn normalization: exp(x / tau), then alternating column and row
normalization of each (n x n) matrix.

Replaces the TPU kernel `scripts/ab_sinkhorn.py::sinkhorn_normalize_pallas`
(one matrix per grid step, the whole iteration loop on-chip), which computes
the same function as `vsrcic_tpu/models/sinkhorn.py::sinkhorn_normalize`:

    v = exp(x / tau)
    n_iters times:  v = v / (EPS + colsum(v));  v = v / (EPS + rowsum(v))

with EPS = 1e-7 added to each sum before the division, as JAX does.

What bounds it on the H100. The byte bound, for the record: each matrix read
once and written once (4 n^2 bytes each way); at the eval pipeline's
S = 1536 matrices of n = 10 that is 1.23 MB, 0.37 us at 3.35 TB/s, less
than a launch. What bounds it in fact is the launch plus one matrix's
dependent chain: 2 n_iters passes, each an n-long add chain and n IEEE
divisions by the same sum, run by one warp scheduler for every warp it
holds. The plain version makes about 4 n_iters + 2 launches; the kernel
makes one.

Kernel design (`csrc/sinkhorn.cu`): for n <= 32 one instantiation per n,
so each pass's n values sit in registers in unrolled code. A warp packs
32 // n matrices for n <= 16 (3 at n = 10, 30 lanes busy) and one above;
lane m * n + c owns column c of its matrix m, then row c, and the values
change hands between passes through a per-warp shared-memory tile of n
rows x 33 floats (one bank per lane both ways). Four warps per block, so
the pipeline's 1536 matrices of n = 10 run as 128 blocks: one wave, one
warp per scheduler. Each warp reads its adjacent matrices in one
coalesced sweep and writes them in one. The n divisions of a pass share
one reciprocal and skip the per-division slow-path branch of '/', with the
same correctly rounded quotients. For 32 < n <= MAX_N one block per
matrix, one thread per column, then per row. All sums run in index order
in f32; x / tau and v / (EPS + sum) are correctly rounded divisions, not
products with a rounded reciprocal, so on the card the kernel gives the
same bits as `sinkhorn_normalize_in_order`.

`sinkhorn_normalize_plain` is the plain PyTorch version. The wrapper
`sinkhorn_normalize` runs it for CPU tensors and launches the kernel for
CUDA tensors; it never falls back. `sinkhorn_normalize_in_order` replays
the kernel's arithmetic for the tests.
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


def sinkhorn_normalize_in_order(x, n_iters: int, tau: float):
    """The kernel's arithmetic step by step: each column sum and each row
    sum from 0.0 in index order, true divisions by tau and by (EPS + sum).
    On the card each step is one IEEE operation, so the kernel must give
    the same bits (tests/test_torch_kernels_cuda.py, chip_smoke.py); ~4 n
    n_iters launches, a reference only."""
    v = torch.exp(x / torch.full((), tau, dtype=x.dtype, device=x.device))
    for _ in range(n_iters):
        for dim in (1, 2):
            s = torch.zeros_like(v.narrow(dim, 0, 1))
            for i in range(v.shape[dim]):
                s = s + v.narrow(dim, i, 1)
            v = v / (EPS + s)
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
