"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA card and skip elsewhere. They import neither JAX nor the
JAX package (tests/conftest.py does, hence --noconftest), so they run where
the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from vsrcic_tpu_torch.ops.fused_attention import (
    fused_group_attention, fused_group_attention_plain)
from vsrcic_tpu_torch.ops.vocab_topk import (vocab_topk_lse,
                                             vocab_topk_lse_plain)

from torch_parity import cuda_device  # noqa: F401  (fixture)
from torch_parity import fused_inputs, fused_torch_args, vocab_case


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 20, 2048, 512),   # full widths
                                   (7, 5, 24, 100, 36)])     # ragged
def test_fused_attention_kernel_matches_plain(cuda_device, shape, table):
    rows, b, m, d, a = shape
    args = fused_torch_args(fused_inputs(m, seed=3, rows=rows, b=b, d=d, a=a),
                            table, cuda_device)
    before = fused_group_attention.launches
    got = fused_group_attention(*args)
    torch.cuda.synchronize()
    assert fused_group_attention.launches == before + 1
    want = fused_group_attention_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties", "multi_chunk", "row_blocked"])
def test_vocab_topk_kernel_matches_plain(cuda_device, case, table):
    h2, w_t, b, k, _ = vocab_case(case)
    args = (torch.from_numpy(h2).to(cuda_device),
            torch.from_numpy(w_t).to(cuda_device, table),
            torch.from_numpy(b).to(cuda_device))
    before = vocab_topk_lse.launches
    got = vocab_topk_lse(*args, k)
    torch.cuda.synchronize()
    assert vocab_topk_lse.launches == before + 1
    want = vocab_topk_lse_plain(*args, k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
