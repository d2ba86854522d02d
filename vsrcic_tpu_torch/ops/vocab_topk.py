"""Fused vocab head: out_fc product + per-row top-k + logsumexp.

Counterpart of `vsrcic_tpu/ops/vocab_topk.py`. The joint (word x gate) beam
needs, per decode row, only the top-k word logits and the row's logsumexp
(`decode/beam.beam_search_joint_candidates`), so the (rows, V) logits never
have to reach device memory. Tie order is `jax.lax.top_k`'s: values
descending, the lowest vocab id first among equal values.

`vocab_topk_lse_plain` is the plain PyTorch version (counterpart of
`vocab_topk_lse_xla`). The wrapper `vocab_topk_lse` runs it for CPU tensors
and launches a CUDA kernel (`csrc/vocab_topk.cu`) for CUDA tensors; it
never falls back. The operands choose the kernel, as `make_vocab_topk_lse`'s
`lhs_dtype` and `table_dtype` choose the TPU kernel's product:

  * f32 h2, f32 or bf16 table: the f32 product on the CUDA cores;
  * bf16 h2, f32 table: h2 upcast (exactly), then the same f32 kernel;
  * bf16 h2, bf16 table: the bf16 product on the tensor cores with f32
    accumulation (`launches_bf16` counts these too).
"""
from __future__ import annotations

import torch

from vsrcic_tpu_torch.core.nn import top_k
from vsrcic_tpu_torch.ops import _build

# the kernel keeps this many candidates per thread; k must not exceed it
K_MAX = 16
# vocab columns per CTA of the kernel's first stage (csrc/vocab_topk.cu)
TILE_V = 128
_FLOATS = (torch.float32, torch.bfloat16)


def vocab_topk_lse_plain(h2, w_t, bias, k: int):
    """Plain version: materialises the logits in f32.

    h2: (rows, R) f32 or bf16; w_t: (R, V) bf16 or f32; bias: (V,). Both
    operands are upcast (exactly) and multiplied in f32; a bf16 x bf16
    product is exact in f32, so this is also the bf16-operand kernel's
    function. -> (vals (rows, k) f32, ids (rows, k) int32, lse (rows, 1)
    f32)."""
    logits = h2.float() @ w_t.float() + bias.float()
    vals, ids = top_k(logits, k)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, ids.to(torch.int32), lse


def vocab_topk_lse(h2, w_t, bias, k: int):
    """Plain version for CPU tensors; a CUDA kernel for CUDA tensors (see
    the module's note). Any rows, R and V; 1 <= k <= min(V, K_MAX); h2 and
    w_t float32 or bfloat16, bias float32 on the card."""
    if h2.dtype not in _FLOATS or w_t.dtype not in _FLOATS:
        raise ValueError("vocab_topk_lse: h2 and w_t must be float32 or "
                         "bfloat16, got %s and %s" % (h2.dtype, w_t.dtype))
    if h2.device.type == "cpu":
        return vocab_topk_lse_plain(h2, w_t, bias, k)
    if h2.device.type != "cuda":
        raise ValueError("vocab_topk_lse: unsupported device %s" % h2.device)
    bf16 = torch.bfloat16
    tensor_cores = h2.dtype == bf16 and w_t.dtype == bf16
    if h2.dtype == bf16 and not tensor_cores:
        h2 = h2.float()   # bf16 h2 x f32 table: an f32 product, as in JAX
    dev = h2.device
    rows, r = h2.shape
    v = w_t.shape[-1]
    if not 1 <= k <= min(v, K_MAX):
        raise ValueError("vocab_topk_lse: k=%d outside [1, min(V=%d, %d)]"
                         % (k, v, K_MAX))
    f32 = torch.float32
    for t, name, shape, dtype in ((h2, "h2", (rows, r), h2.dtype),
                                  (w_t, "w_t", (r, v), w_t.dtype),
                                  (bias, "bias", (v,), f32)):
        _build.check_tensor(t, name, shape, dtype, dev)
    vals = torch.empty((rows, k), dtype=f32, device=dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    lse = torch.empty((rows, 1), dtype=f32, device=dev)
    if rows == 0:
        return vals, ids, lse
    n_tiles = (v + TILE_V - 1) // TILE_V
    part_vals = torch.empty((n_tiles, rows, k), dtype=f32, device=dev)
    part_ids = torch.empty((n_tiles, rows, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((n_tiles, rows), dtype=f32, device=dev)
    part_s = torch.empty((n_tiles, rows), dtype=f32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = (part_vals.data_ptr(), part_ids.data_ptr(), part_m.data_ptr(),
             part_s.data_ptr(), vals.data_ptr(), ids.data_ptr(),
             lse.data_ptr(), stream)
    if tensor_cores:
        err = lib.vsrcic_vocab_topk_bf16(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(), rows, r, v, k,
            *parts)
    else:
        err = lib.vsrcic_vocab_topk(
            h2.data_ptr(), w_t.data_ptr(), bias.data_ptr(),
            int(w_t.dtype == bf16), rows, r, v, k, *parts)
    _build.check(err, "vocab_topk_lse")
    vocab_topk_lse.launches += 1
    if tensor_cores:
        vocab_topk_lse.launches_bf16 += 1
    return vals, ids, lse


vocab_topk_lse.launches = 0
vocab_topk_lse.launches_bf16 = 0
