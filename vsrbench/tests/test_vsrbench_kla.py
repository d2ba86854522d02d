"""The Kimi-Linear cell's files: the yardstick against hand counts at a tiny
shape, the generator's inputs, the metrics' readers on a made-up slice,
and runs on the CPU, right and with faults that the limits catch."""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

from vsrbench import harness, layout
from vsrbench import yardstick as ys
from vsrbench import yardstick_kla as yk
from vsrbench import yardstick_vlm as yv
from vsrbench.drivers import eval_stream, eval_stream_kla
from vsrbench.tests.tiny import run_cell
from vsrbench.tests.tiny_kla import CELL, tiny_kla_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_kla_root(tmp_path_factory.mktemp("tiny_kla"))


def tiny_model(root):
    return yk.model(layout.cell(CELL, root).config)


def test_yardstick_hand_counts(root):
    """hidden 64; KDA 4 heads of 16 (conv 4) at layers 0, 1, 2, 4; MLA 4
    heads of 16 + 8, latent 32, v 16 at 3 and 5; dense 96 at layer 0;
    experts of 32 (16 routed, 8 held, top 4, 1 shared); vocab 50; det
    16."""
    c = tiny_model(root)
    assert c["kda_layers"] == [0, 1, 2, 4]
    assert yk.held_share(c) == 0.5
    # W_q, W_k, W_v, W_fa, W_ga, W_b; W_fb, W_gb; W_o; the conv taps
    assert yk.kda_proj_macs(c) == (64 * (3 * 64 + 2 * 16 + 4) + 2 * 16 * 64
                                   + 64 * 64 + 3 * 64 * 4) == 21504
    assert yk.kda_recurrence_flops(c) == 7 * 4 * 16 * 16
    assert yk.mlp_macs(c, 0, 0.5) == 3 * 64 * 96
    assert yk.mlp_macs(c, 1, 0.5) == 64 * 16 + (4 * 0.5 + 1) * 3 * 64 * 32
    proj = yv.attn_proj_macs(c)
    # one job of 3 real tokens: projector, KDA and MLA layers, MLPs
    want = 2.0 * 3 * (16 * 64 + 64 * 64)
    for layer in range(6):
        want += 2.0 * 3 * yk.mlp_macs(c, layer, 0.5)
        if layer in (0, 1, 2, 4):
            want += 3 * (2.0 * 21504 + 7168)
        else:
            want += 2.0 * (3 * proj + 6 * 4 * (16 + 8 + 16))
    assert yk.prefill_flops(c, [3], 0.5) == want
    mlp = sum(yk.mlp_macs(c, i, 0.5) for i in range(6))
    want = sum(2 * (2.0 * (2 * yv.attn_decode_macs(c, 3 + t + 1) + mlp
                           + 64 * 52) + 4 * (2.0 * 21504 + 7168))
               for t in range(6))
    assert yk.decode_flops(c, [3], 2, 0.5) == want


def test_kda_bounds(root):
    """Decode: each distinct parent state read once, every row's own
    written, its five vectors and beta; prefill: the state written once,
    each real token's vectors; per layer the larger of bytes over HBM and
    operations over the CUDA cores."""
    c = tiny_model(root)
    # 2 rows over 6 steps reading 9 distinct parents in all
    layer = max(6 * 2 * 7168 / yk.F32_CUDA_FLOPS,
                4 * 4 * (9 * 256 + 6 * 2 * (256 + 5 * 16 + 1))
                / yk.HBM_BYTES_PER_S)
    assert yk.kda_decode_bound_s(c, 2, 9) == pytest.approx(4 * layer)
    # every row its own parent: each row's state read and written
    assert yk.kda_decode_bound_s(c, 2, 12) == pytest.approx(
        4 * 6 * max(2 * 7168 / yk.F32_CUDA_FLOPS,
                    4 * 2 * 4 * (2 * 256 + 5 * 16 + 1)
                    / yk.HBM_BYTES_PER_S))
    assert yk.kda_decode_bound_s(c, 2, 6) < yk.kda_decode_bound_s(c, 2, 12)
    call = max(7 * 7168 / yk.F32_CUDA_FLOPS,
               4 * 4 * (2 * 256 + 7 * (5 * 16 + 1)) / yk.HBM_BYTES_PER_S)
    assert yk.kda_prefill_bound_s(c, [3, 4]) == pytest.approx(4 * call)


@pytest.mark.parametrize("seed", (7, 2 ** 31 + 11, 2 ** 40 + 3))
def test_same_seed_same_inputs(root, seed):
    cell = layout.cell(CELL, root)
    dev = torch.device("cpu")
    wa = eval_stream_kla.make_weights(cell.config, seed, dev)
    wb = eval_stream_kla.make_weights(cell.config, seed, dev)
    for name in ("in_proj", "conv", "A_log", "dt_bias"):
        assert torch.equal(wa["kimi"]["layers"][0][name],
                           wb["kimi"]["layers"][0][name])
    assert torch.equal(wa["kimi"]["layers"][3]["experts_down"],
                       wb["kimi"]["layers"][3]["experts_down"])
    assert wa["probe"] == wb["probe"]
    # the decay's draw: alpha = exp(-A dt) in [0.905, 0.9995] at f = 0
    lp = wa["kimi"]["layers"][0]
    alpha = torch.exp(-torch.exp(lp["A_log"])[:, None]
                      * torch.nn.functional.softplus(lp["dt_bias"]).view(
                          4, 16))
    assert 0.904 < float(alpha.min()) and float(alpha.max()) < 0.9996


def test_metrics_read_a_slice(root):
    cell = layout.cell(CELL, root)
    tr = cell.traffic
    pool = [SimpleNamespace(n_real=[3, 5, 7, 4, 6, 7], plan_flops=1e9)] * 2
    counts = {"prefix_tokens": 64, "prefill_pairs": 128,
              "prefill_experts_hit": 30, "decode_pairs": 1440,
              "decode_experts_hit": 190, "vocab": 0, "kda_parents": 240}

    class Slice:
        window_s, busy_s = 1.0, 0.25
        kernels = [("k", 0.0, 1.0)]

        def __init__(self, counters, kda_ms):
            self.counters, self.kda_ms = counters, kda_ms

        def device_ms(self, prefixes):
            assert prefixes == ("kda_",)
            return self.kda_ms, 10

    ctx = SimpleNamespace(config=cell.config, traffic=tr, units=4,
                          window_s=2.0, pool=pool,
                          shape=eval_stream.shape_of(cell.config, tr),
                          slice=Slice(counts, 5.0),
                          span_ms={"vlm.attn": 3.0, "vlm.moe": 2.0,
                                   "vlm.kda": 5.0})
    got = harness.read_metrics(cell, ctx)
    assert set(got) == {"kda_roofline_pct.kla", "moe_roofline_pct.kla",
                        "mfu_pct.kla", "device_idle_pct.kla"}
    c = tiny_model(root)
    least = sum(yk.kda_prefill_bound_s(c, pool[0].n_real)
                + yk.kda_decode_bound_s(c, 6 * 5, 240 / 2)
                for _ in range(2))
    assert got["kda_roofline_pct.kla"]["value"] == pytest.approx(
        100 * least / 5e-3)
    # held share from the counts: pairs over tokens x 5 MoE layers x top 4
    share = (128 + 1440) / ((64 + 2 * 6 * 5 * 6) * 5 * 4)
    flops = 4 * (yk.prefill_flops(c, pool[0].n_real, share)
                 + yk.decode_flops(c, pool[0].n_real, 5, share) + 1e9)
    assert got["mfu_pct.kla"]["value"] == pytest.approx(
        100 * flops / (2.0 * ys.BF16_DENSE_FLOPS))
    assert 0 < got["moe_roofline_pct.kla"]["value"] < 100
    assert got["device_idle_pct.kla"]["value"] == 75.0
    # the parent's slice: no kernel, span or count: nothing read, nothing
    # raised
    ctx.span_ms = {}
    ctx.slice = Slice(None, 0.0)
    ctx.slice.kernels, ctx.slice.busy_s = [], 0.0
    got = harness.read_metrics(cell, ctx)
    assert set(got) == {"mfu_pct.kla"}


def test_cell_runs_correct(root):
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is True
    assert set(line["checks"]) == set(json.loads(
        (root / "vsrbench" / "limits" / (CELL + ".json")).read_text()))
    assert line["checks"]["state_gap"]["value"] < 1e-5


def _stale_parent(monkeypatch):
    from vsrcic_tpu_torch.models import kimi_linear as kl
    monkeypatch.setattr(kl.KdaState, "__getitem__",
                        lambda self, rows: kl.KdaState(self.state, self.conv,
                                                       self.parent))


def _no_decay(monkeypatch):
    from vsrcic_tpu_torch.models import kimi_linear as kl
    project = kl.kda_project

    def no_decay(lp, cfg, x):
        qkv, g, beta, gate = project(lp, cfg, x)
        return qkv, torch.zeros_like(g), beta, gate
    monkeypatch.setattr(kl, "kda_project", no_decay)


def _conv_dropped(monkeypatch):
    from vsrcic_tpu_torch.models import kimi_linear as kl
    step = kl.conv_step
    monkeypatch.setattr(kl, "conv_step", lambda qkv, conv, parent, w: step(
        qkv, torch.zeros_like(conv), parent, w))


def _rope_on_mla(monkeypatch):
    """The prefix's MLA turned by RoPE at its tokens' positions."""
    from vsrcic_tpu_torch.models import kimi_linear as kl
    from vsrcic_tpu_torch.models import kimi_vl as kv
    pre = kl.mla_prefill
    monkeypatch.setattr(kl, "mla_prefill", lambda lp, cfg, x, rot, mask: pre(
        lp, cfg, x, kv.rope_angles(torch.arange(x.shape[1]).expand(
            x.shape[0], -1), cfg), mask))


def _non_held_computed(monkeypatch):
    """The program computes 16 experts where the chip holds 8: the held
    ones and 8 more."""
    build = eval_stream_kla.build_program

    def computes_all(cfg, w, device):
        more = dict(w["kimi"], layers=[
            dict(lp, experts_gate_up=torch.cat([lp["experts_gate_up"]] * 2),
                 experts_down=torch.cat([lp["experts_down"]] * 2))
            if "router" in lp else lp for lp in w["kimi"]["layers"]])
        kc = dataclasses.replace(w["kimi_cfg"], experts_held=16)
        return build(cfg, dict(w, kimi=more, kimi_cfg=kc), device)
    monkeypatch.setattr(eval_stream_kla, "build_program", computes_all)


@pytest.mark.parametrize("fault", [_stale_parent, _no_decay, _conv_dropped,
                                   _rope_on_mla, _non_held_computed],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_caught(root, monkeypatch, fault):
    fault(monkeypatch)
    rc, line = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and line["correct"] is False
