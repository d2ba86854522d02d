"""The port's fused group attention against the JAX Pallas kernel, run in
interpret mode as tests/test_fused_attention.py runs it (the CUDA kernel is
held against its plain version in tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsrcic_tpu.ops.fused_attention import make_fused_group_attention
from vsrcic_tpu_torch.ops.fused_attention import fused_group_attention

from torch_parity import (FA_A as A, FA_B as B, FA_D as D, FA_L as L,
                          FA_ROWS as ROWS, fused_inputs as _inputs,
                          fused_torch_args as _torch_args)


@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("m", [5, 8])           # M unpadded and padded
@pytest.mark.parametrize("rpb", [2, ROWS])      # multi- and single-block
def test_plain_matches_pallas_interpret(rpb, m, table):
    args = _inputs(m)
    tdt_j = jnp.bfloat16 if table == "bf16" else jnp.float32
    tdt_t = torch.bfloat16 if table == "bf16" else torch.float32
    jargs = [jnp.asarray(x) for x in args]
    jargs[7], jargs[8] = jargs[7].astype(tdt_j), jargs[8].astype(tdt_j)
    fn = make_fused_group_attention(B, L, m, D, A, ROWS, rows_per_block=rpb,
                                    interpret=True, table_dtype=tdt_j)
    want_att, want_gsum = fn(*jargs)
    before = fused_group_attention.launches
    got_att, got_gsum = fused_group_attention(*_torch_args(args, tdt_t))
    assert fused_group_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gsum.numpy(), np.asarray(want_gsum),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    args = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                        device="meta") for x in _inputs(5)]
    with pytest.raises(ValueError):
        fused_group_attention(*args)

