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
from vsrcic_tpu_torch.ops.sinkhorn import (MAX_N, sinkhorn_normalize,
                                           sinkhorn_normalize_in_order,
                                           sinkhorn_normalize_plain)
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


# n at the edges of the kernel's packing: 32 // n matrices per warp up to
# n = 16, one per warp up to 32, one block per matrix above
SINK_N = [1, 2, 3, 10, 11, 16, 17, 31, 32, 33, 64, 241]


def sink_scores(device, s, n, seed):
    """Scores as sinkhorn_net_apply hands them over: tanh, in (-1, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.tanh(torch.randn((s, n, n), generator=gen, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SINK_N)
@pytest.mark.parametrize("s", [1, 7, 1536, 1537])
def test_sinkhorn_kernel_matches_plain(cuda_device, s, n):
    """Within 1e-6 of the plain version on scores in (-1, 1), with S a
    whole number of warps' groups or not."""
    x = sink_scores(cuda_device, s, n, seed=n)
    before = sinkhorn_normalize.launches
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert sinkhorn_normalize.launches == before + 1
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, 20, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 10, 16, 17, 32, 33])
def test_sinkhorn_kernel_equals_its_arithmetic_replayed(cuda_device, n):
    """Sums in index order and correctly rounded divisions, as the replay
    does them one IEEE operation at a time: the same bits."""
    x = sink_scores(cuda_device, 1537, n, seed=2 * n)
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, sinkhorn_normalize_in_order(x, 20, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 1])
@pytest.mark.parametrize("n", [3, 10, 17, 33])
def test_sinkhorn_kernel_few_iterations(cuda_device, n, n_iters):
    """No iteration is exp(x / tau) alone; one is one column and one row
    pass."""
    x = sink_scores(cuda_device, 1537, n, seed=n_iters)
    got = sinkhorn_normalize(x, n_iters, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, n_iters, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10, 17, 33])
def test_sinkhorn_kernel_equal_scores_give_uniform(cuda_device, n):
    x = torch.full((1537, n, n), 0.3, device=cuda_device)
    got = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, torch.full_like(x, 1.0 / n), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got, sinkhorn_normalize_plain(x, 20, 0.1),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 33])
def test_sinkhorn_kernel_is_deterministic(cuda_device, n):
    x = sink_scores(cuda_device, 1536, n, seed=5)
    first = sinkhorn_normalize(x, 20, 0.1)
    second = sinkhorn_normalize(x, 20, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_sinkhorn_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros((4, 10, 10), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_normalize(x.double(), 20, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_normalize(x.transpose(1, 2), 20, 0.1)
    with pytest.raises(ValueError, match="exceeds"):
        sinkhorn_normalize(torch.zeros((1, MAX_N + 1, MAX_N + 1),
                                       device=cuda_device), 20, 0.1)
