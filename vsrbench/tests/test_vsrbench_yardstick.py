"""The yardstick's arithmetic against values worked by hand on tiny
shapes, and the trace reduction on a made-up slice."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from vsrbench import harness, yardstick as ys

C = {"rnn_size": 2, "input_encoding_size": 3, "det_feat_size": 4,
     "att_size": 5, "vocab_size": 7, "h2_first_lstm": True,
     "img_second_lstm": False}


def test_step_macs_by_hand():
    # x (R+E=5) x 6R=12: 60; h 2 x 10: 20; s_fc 2x4: 8; 3 R x A: 30;
    # W1_hg 4; regions 3 x (A + D = 9): 27; LSTM2 (R + D = 6) x 8: 48;
    # recurrent 2 x 8: 16; vocab 2 x 7: 14  -> 227
    assert ys.step_macs(C, 3, False) == 227
    # + the groups' projection 3 x D x A = 60
    assert ys.step_macs(C, 3, True) == 287
    # no h2 in the first LSTM: x is E = 3 wide, 3 x 12 = 36 (24 fewer)
    assert ys.step_macs(dict(C, h2_first_lstm=False), 3, False) == 203


def test_item_macs_and_batches_by_hand():
    # image columns D x 6R = 48; 2 groups x 3 regions x D x A = 120
    assert ys.item_macs(C, 2, 3) == 168
    # 2 items x beam 3 x 4 steps x 227 + 2 x 168, doubled
    assert ys.beam_batch_flops(C, 2, 3, 4, 2, 3) == 2.0 * (24 * 227 + 336)
    # 3 x 2 x (rows 2 x 4 steps x 287 + 2 x 48)
    assert ys.xe_step_flops(C, 2, 4, 3) == 6.0 * (8 * 287 + 96)


def test_planner_flops_by_hand():
    p = {"hidden_size": 2, "add_fc": True, "encoder_layers": 1,
         "decoder_layers": 1}
    # ff 8; encoder a token: fc 4 + (16 + 32 + 2 x 3 x 2 = 12) = 64, x 3
    # tokens = 192; cross K/V 2 x 3 x 4 = 24; decoder a step: 6 x 4 + 32 +
    # 2 x (2 + 3) x 2 = 76, + head 52 = 128, x 2 steps = 256
    assert ys.ssp_flops(p, 1, 3, 2) == 2.0 * (192 + 24 + 256)
    s = {"n": 2, "txt_dim": 1, "vis_dim": 1, "pos_dim": 1, "n_iters": 3}
    # a row: 128 + 512 + 65536 + 257 x 256 + 512 = 132480, x n = 2
    mlp = 2 * (128 + 512 + 512 * 128 + 257 * 256 + 256 * 2)
    assert ys.sinkhorn_flops(s, 1, 5) == 5 * (2.0 * mlp + 4.0 * 3 * 4)


def test_bounds_by_hand():
    # one product: 2 x 2560 x 1000 x 10000 over 989e12
    t = ys.vocab_head_bound_s(2560, 1000, 10000, 5, 4, 4)
    assert t == pytest.approx(5.12e10 / 989e12)
    # a tiny call is bound by its bytes: h2 4 x 3 x 4, table 3 x 5 x 2,
    # bias 20, outputs 4 x 3 x 4 -> 146 bytes
    assert ys.vocab_head_bound_s(4, 3, 5, 1, 4, 2) == pytest.approx(
        146 / ys.HBM_BYTES_PER_S)


def test_union_and_slice():
    assert ys.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    tracer = SimpleNamespace(
        window=lambda: (0.0, 10.0),
        kernels=[("void vocab_tma_kernel<3, 3>(x)", 1.0, 3.0),
                 ("vocab_merge_kernel", 3.0, 4.0), ("gemm", 8.0, 12.0)],
        host=[("vsrbench.unit", 0.0, 10.0), ("plan_finish", 4.0, 7.0)],
        counters_delta=lambda: {"vocab": 1}, boundary={1: {"vocab": 3}},
        first=1)
    sl = harness.Slice(tracer, ("plan_finish",))
    assert sl.window_s == pytest.approx(1e-5)
    assert sl.busy_s == pytest.approx(5e-6)       # 1-4 and 8-10 (clipped)
    ms, n = sl.device_ms(("vocab_",))
    assert (ms, n) == (pytest.approx(3e-3), 2)
    bd = sl.breakdown()
    assert bd["device_ops"][0][0] == "gemm"
    assert bd["idle_gaps"][0] == ["plan_finish", pytest.approx(4e-6)]
    assert bd["idle_gaps"][1] == ["outside the spans", pytest.approx(1e-6)]
