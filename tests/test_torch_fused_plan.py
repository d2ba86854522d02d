"""The fused attention kernel's launch plan (`fused_launch_plan`), on the CPU:
at every shape `chip_smoke.py` phase 3 checks and the eval (13b) and train
(14b) CLIs run, and at the tests' shapes, the blocks' slices tile D and A
exactly in whole TMA boxes and fit a block's shared memory. Plus the plain
version against the JAX Pallas kernel (interpret mode) on item-major rows
whose ctrl is shared in runs, as the beams of one item share it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsrcic_tpu.ops.fused_attention import make_fused_group_attention
from vsrcic_tpu_torch.ops import fused_attention as fa

from torch_parity import (FA_A, FA_B, FA_D, FA_L, FA_ROWS, fused_inputs,
                          fused_torch_args)

FULL = (chip_smoke.DET, chip_smoke.ATT)
# (rows, M, D, A): phase 3's cases (chip_smoke.FUSED_CASES, its timed
# shapes among them) and its out-of-range rows', the eval CLI's batches of
# 512 items x beam 5 and its last, the train CLIs' batches of 100 (SCST)
# and the eval CLI's 16 x 5 from their checkpoints, and the tests' shapes
SHAPES = sorted(
    {c[1:2] + c[3:6] for c in chip_smoke.FUSED_CASES}
    | {(37, 24) + FULL, (37, 5, 100, 36)}
    | {(rows, m) + FULL for rows in (1, 2, 5, 16, 64, 80, 100, 320, 512,
                                     1024, 2560, 5120)
       for m in (20, 24)}
    | {(FA_ROWS, m, FA_D, FA_A) for m in (5, 8)}
    | {(5, 24, 2048, 512), (7, 24, 100, 36)}
    | {(rows, 20, 2048, 512) for rows in (1024, 37, 1)})


def _tiles(width, slice_, box, c):
    """The blocks' column ranges tile [0, width) exactly, each in whole
    boxes but the last (whose boxes may run past `width`)."""
    ranges = [(min(r * slice_, width), min((r + 1) * slice_, width))
              for r in range(c)]
    assert ranges[0][0] == 0 and ranges[-1][1] == width
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert slice_ % box == 0


@pytest.mark.parametrize("table_bytes", [2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_tiles_and_fits(shape, table_bytes):
    rows, m, d, a = shape
    plan = fa.fused_launch_plan(rows, m, d, a, table_bytes)
    assert 2 <= plan.cluster <= 8
    _tiles(d, plan.d_slice, plan.box_d, plan.cluster)
    _tiles(a, plan.a_slice, plan.box_a, plan.cluster)
    assert plan.smem_bytes <= 232_448
    assert plan.runs * plan.rows_per_run >= rows
    assert (plan.runs - 1) * plan.rows_per_run < rows
    assert plan.rows_per_run + fa.MAX_BATCH + 1 <= 256  # the scan window
    assert 1 <= plan.batch <= fa.MAX_BATCH
    vec = 16 // table_bytes
    assert plan.bulk == (d % vec == 0 and a % vec == 0 and m <= 256)
    if plan.bulk:   # TMA boxes: at most 256 columns of whole 16 bytes
        for box in (plan.box_d, plan.box_a):
            assert box <= 256 and box * table_bytes % 16 == 0
    else:           # element copies: one box a slice
        assert (plan.box_d, plan.box_a) == (plan.d_slice, plan.a_slice)


@pytest.mark.parametrize("m", [20, 24, 33])
def test_f32_full_width_splits(m):
    """A whole f32 group (up to 33 x 2560 x 4 B) does not fit one block:
    the plan splits it."""
    plan = fa.fused_launch_plan(5120, m, 2048, 512, 4)
    assert plan.cluster > 1
    assert plan.smem_bytes <= 232_448


def test_plan_is_cached_and_follows_the_card():
    a = fa.fused_launch_plan(1024, 20, 2048, 512, 2)
    assert fa.fused_launch_plan(1024, 20, 2048, 512, 2) is a
    # a card of half the SMs holds half the clusters: longer runs
    b = fa.fused_launch_plan(1024, 20, 2048, 512, 2, sms=66)
    assert (a.rows_per_run, b.rows_per_run) == (2, 3)
    assert (b.cluster, b.batch, b.d_slice) == (a.cluster, a.batch, a.d_slice)
    # tensors off 16-byte alignment take the element copies
    c = fa.fused_launch_plan(1024, 20, 2048, 512, 2, aligned=False)
    assert not c.bulk and (c.box_d, c.box_a) == (c.d_slice, c.a_slice)


@pytest.mark.parametrize("kwargs", [
    dict(rows=8, m=256, d=65536, a=512, table_bytes=4),   # no cluster fits
    dict(rows=8, m=24, d=2048, a=512, table_bytes=4,
         cluster=1),                                     # 240 KB, one block
    dict(rows=8, m=20, d=2048, a=512, table_bytes=2, batch=9),
    dict(rows=8, m=20, d=2048, a=512, table_bytes=2, sms=0),
    dict(rows=8, m=20, d=2048, a=512, table_bytes=3),
    dict(rows=0, m=20, d=2048, a=512, table_bytes=2),
    dict(rows=8, m=20, d=2048, a=512, table_bytes=2, run=300),
])
def test_plan_raises_when_nothing_fits(kwargs):
    with pytest.raises(ValueError):
        fa._plan(**dict(dict(aligned=True, sms=132), **kwargs))


@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_plain_matches_pallas_on_shared_runs(table):
    """Rows item-major in runs of the same (item, ctrl), as the kernel's
    segments see them: the plain version against the JAX Pallas kernel in
    interpret mode."""
    m = 8
    args = list(fused_inputs(m, seed=5))
    rng = np.random.RandomState(11)
    args[1] = rng.randint(0, FA_L, FA_B).astype(np.int32)[args[0]]
    assert (np.diff(args[0]) >= 0).all()
    tdt_j = jnp.bfloat16 if table == "bf16" else jnp.float32
    tdt_t = torch.bfloat16 if table == "bf16" else torch.float32
    jargs = [jnp.asarray(x) for x in args]
    jargs[7], jargs[8] = jargs[7].astype(tdt_j), jargs[8].astype(tdt_j)
    fn = make_fused_group_attention(FA_B, FA_L, m, FA_D, FA_A, FA_ROWS,
                                    rows_per_block=2, interpret=True,
                                    table_dtype=tdt_j)
    want_att, want_gsum = fn(*jargs)
    got_att, got_gsum = fa.fused_group_attention_plain(
        *fused_torch_args(args, tdt_t))
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gsum.numpy(), np.asarray(want_gsum),
                               rtol=1e-5, atol=1e-5)
