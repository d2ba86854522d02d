"""The bf16 vocab kernel's launch plan (`ops/vocab_topk.py::
vocab_bf16_launch_plan`, and `vocab_launch_plan` on a non-finite table),
pure Python: the route each shape takes, the shared bytes, the tile
walk, and the constants the CUDA source shares with it. The kernels
themselves are held to their plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 3)."""
import collections
import math
import re
from pathlib import Path

import pytest
import torch

from vsrcic_tpu_torch.ops import vocab_topk as vt

CSRC = (Path(vt.__file__).resolve().parent.parent / "csrc"
        / "vocab_topk.cu").read_text()

BEAM = (5120, 1000, 10000, 5)            # rows 1024 x beam 5, R, V, k
RAGGED = [(37, 77, 1001, 5), (101, 129, 257, 16), (3, 1000, 130, 1),
          (24, 16, 260, 4), (16, 24, 300, 5)]
ALIGNED = [BEAM, (130, 64, 136, 5), (512, 1000, 10000, 5), (1, 8, 8, 8),
           (2560, 1000, 30 * 8, 5), (100, 1000, 10000, 16)]


def _const(name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         CSRC).group(1))


def test_beam_shape_takes_the_tma_route():
    plan = vt.vocab_bf16_launch_plan(*BEAM, aligned=True, sms=132)
    assert plan.route == "tma"
    assert plan.grid == 132 and plan.grid % plan.cluster == 0
    assert plan.cluster == vt.TMA_CLUSTER
    assert (plan.tile_m, plan.tile_n) == (128, 256)
    # a card that holds fewer clusters at once gets no second wave
    assert vt.vocab_bf16_launch_plan(*BEAM, sms=132,
                                     resident=60).grid == 60 * plan.cluster
    assert plan.smem_bytes <= vt.SMEM_MAX


@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_shapes_take_mma_sync(shape):
    plan = vt.vocab_bf16_launch_plan(*shape, aligned=True, sms=132)
    assert plan.route == "mma_sync"
    rows, _, v, _ = shape
    assert plan.grid == math.ceil(rows / 128) * math.ceil(v / 128)
    assert (plan.tile_n, plan.cluster) == (128, 1)
    assert plan.smem_bytes == vt.MMA_SYNC_SMEM


@pytest.mark.parametrize("shape", ALIGNED)
def test_unaligned_bases_take_mma_sync(shape):
    assert vt.vocab_bf16_launch_plan(*shape, aligned=True).route == "tma"
    assert vt.vocab_bf16_launch_plan(*shape,
                                     aligned=False).route == "mma_sync"


@pytest.mark.parametrize("shape", ALIGNED + RAGGED)
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_shared_memory_fits(shape, sms):
    plan = vt.vocab_bf16_launch_plan(*shape, sms=sms)
    assert 0 < plan.smem_bytes <= vt.SMEM_MAX
    assert 1 <= plan.grid
    if plan.route == "tma":
        assert plan.grid <= sms
        assert plan.smem_bytes == (1024 + plan.stages * vt.TMA_STAGE_BYTES
                                   + 16 * plan.stages)
        assert (_const("T_MIN_STAGES") <= plan.stages
                <= _const("T_MAX_STAGES"))


@pytest.mark.parametrize("shape", [BEAM] + ALIGNED[1:] + RAGGED)
@pytest.mark.parametrize("sms", [132, 5])
def test_tile_walk_covers_every_tile_once(shape, sms):
    rows, _, v, _ = shape
    plan = vt.vocab_bf16_launch_plan(*shape, sms=sms)
    walk = vt.tile_walk(plan, rows, v)
    assert len(walk) == plan.grid
    seen = collections.Counter(t for cta in walk for t in cta)
    n_rb, n_vt = math.ceil(rows / 128), math.ceil(v / plan.tile_n)
    assert set(seen) == {(rb, c) for rb in range(n_rb) for c in range(n_vt)}
    assert set(seen.values()) == {1}
    if plan.route == "tma":   # clusters' loads differ by at most one group
        groups = [len(cta) for cta in walk[::plan.cluster]]
        assert max(groups) - min(groups) <= 1


@pytest.mark.parametrize("bad", [
    dict(rows=0), dict(r=0), dict(v=0), dict(k=0), dict(k=17),
    dict(v=4, k=5), dict(sms=0), dict(aligned=1), dict(resident=0)])
def test_bad_inputs_raise(bad):
    args = dict(zip(("rows", "r", "v", "k"), BEAM), aligned=True, sms=132)
    args.update(bad)
    with pytest.raises(ValueError):
        vt.vocab_bf16_launch_plan(**args)


def test_constants_match_the_cuda_source():
    assert (_const("TR"), _const("TV")) == (vt.TILE_M, vt.TILE_V)
    assert (_const("T_BM"), _const("T_BN")) == (vt.TILE_M, vt.TMA_TILE_V)
    assert _const("T_BK") == vt.TMA_DEPTH
    assert _const("T_MAX_STAGES") >= vt.TMA_STAGES
    assert _const("T_CLUSTER") == vt.TMA_CLUSTER
    assert _const("K_MAX") == vt.K_MAX
    tr, tv, bk = _const("TR"), _const("TV"), _const("BK")
    pipe = 2 * (tr * (bk + 8) + bk * (tv + 8)) * 2
    assert max(pipe, tr * (tv + 4) * 4) == vt.MMA_SYNC_SMEM


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("shape", [BEAM, (7, 1000, 10000, 16),
                                   (257, 1000, 392, 3), (130, 64, 136, 5),
                                   (1, 8, 8, 8)])
def test_ring_depths_cover_every_tile_once(shape, stages):
    """Every ring depth of the sweep (tools/ab_vocab.py): whole clusters,
    no more than the card holds or the groups need, every tile once (a
    group's row blocks past the rows are not listed)."""
    rows, r, v, k = shape
    plan = vt._plan(rows, r, v, k, True, 132, stages=stages)
    assert (plan.cluster, plan.stages) == (vt.TMA_CLUSTER, stages)
    assert plan.grid % plan.cluster == 0 and 1 <= plan.grid <= 132
    walk = vt.tile_walk(plan, rows, v)
    seen = collections.Counter(t for cta in walk for t in cta)
    n_rb, n_vt = math.ceil(rows / 128), math.ceil(v / 256)
    assert set(seen) == {(rb, c) for rb in range(n_rb) for c in range(n_vt)}
    assert set(seen.values()) == {1}
    for bad in (1, 5):
        with pytest.raises(ValueError):
            vt._plan(rows, r, v, k, True, 132, stages=bad)


F32, BF16 = torch.float32, torch.bfloat16
# (h2 dtype, table dtype, R) -> the route of a finite table; W_t padded
# (rows 10000 apart), bases aligned
FINITE_ROUTES = {(F32, BF16, 1000): "split", (F32, F32, 1000): "split9",
                 (BF16, F32, 1000): "split_w", (BF16, BF16, 1000): "tma",
                 (BF16, F32, 1001): "split9"}


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("lhs,table,r", list(FINITE_ROUTES),
                         ids=["f32_bf16", "f32_f32", "bf16_f32", "bf16_bf16",
                              "bf16_f32_ragged_r"])
def test_nonfinite_table_plan(lhs, table, r, finite):
    """finite_table=False (the caller's knowledge that W_t holds a
    non-finite entry) turns the routes that split h2 into three planes
    ("split", "split9", the latter also for a bf16 h2 upcast at a ragged
    R) into "sgemm", whose f32 product gives +-inf where an infinite weight
    meets a zero plane of h2; "split_w" and "tma" keep h2 as one plane and
    keep their plans; a finite table keeps today's routes."""
    args = (5120, r, 9999, 5, lhs, table, True, 132)
    plan = vt.vocab_launch_plan(*args, ldw=10000, finite_table=finite)
    route = FINITE_ROUTES[lhs, table, r]
    if finite or route in ("split_w", "tma"):
        assert plan == vt.vocab_launch_plan(*args, ldw=10000)
        assert plan.route == route
    else:
        assert plan == vt._sgemm_plan(5120, 9999)
        assert (plan.route, plan.planes, plan.w_planes) == ("sgemm", 1, 1)
    with pytest.raises(ValueError):
        vt.vocab_launch_plan(*args, ldw=9998, finite_table=finite)
