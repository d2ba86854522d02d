"""The in-process A/B of the program's recorder (`vsrbench/span_ab.py`):
its arithmetic on made-up blocks, its schedule on a stand-in unit, and
both cells' programs at tiny shapes on the CPU."""
from __future__ import annotations

import gc

import pytest
import torch

from vsrbench import layout, span_ab
from vsrbench.tests.tiny import CELLS, tiny_root
from vsrcic_tpu_torch.utils import observability as obs

CPU = torch.device("cpu")


def test_compare_leaves_gc_units_out_of_the_pairs():
    blocks = [{"on": [(0.102, None), (0.102, None)],
               "off": [(0.100, None), (0.100, None)]},
              {"on": [(0.101, None), (0.401, 0.3)],
               "off": [(0.100, None), (0.100, None)]},
              {"on": [(0.5, 0.4)], "off": [(0.1, None)]}]
    out = span_ab.compare(blocks)
    assert out["units"] == {"on": 3, "off": 5}
    assert out["gc_pauses_ms"] == {"on": pytest.approx([300.0, 400.0]),
                                   "off": []}
    assert out["pairs"] == 2       # the third pair has no unit on left
    assert out["pair_rel"] == pytest.approx([0.1 / 0.102 - 1,
                                             0.1 / 0.101 - 1])
    assert out["pair_rel_mean"] == pytest.approx(
        (0.1 / 0.102 + 0.1 / 0.101) / 2 - 1)
    assert out["pair_rel_se"] > 0
    assert out["ms_a_unit"]["on"] == pytest.approx((102 + 102 + 101) / 3)
    assert out["ms_a_unit_with_gc"]["on"] == pytest.approx(
        (102 + 102 + 101 + 401 + 500) / 5)
    assert out["ms_a_unit"]["off"] == pytest.approx(100.0)


def test_ab_alternates_the_recorder_in_pairs():
    rec = obs.Recorder()
    seen = []
    calls = [0]

    def unit():
        calls[0] += 1
        seen.append(rec.enabled)
        with rec.span("unit"):
            if calls[0] == 8:
                gc.collect()       # a full collection in one unit
    blocks, spans = span_ab.ab(unit, rec, pairs=6, units=2, seed=5, dev=CPU)
    assert len(blocks) == 6 and calls[0] == 6 * 2 * 3
    # each block: one unit untimed, then `units` timed, all in one mode
    assert all(len(seen[i:i + 3]) == 3 and len(set(seen[i:i + 3])) == 1
               for i in range(0, len(seen), 3))
    firsts = [seen[i] for i in range(0, len(seen), 6)]
    assert True in firsts and False in firsts     # the order is drawn
    assert spans == 1.0
    assert sum(g is not None for p in blocks for m in p
               for _, g in p[m]) == 1
    assert rec.enabled and rec.closed() == []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_units_at_tiny_shapes(cell, tmp_path):
    root = tiny_root(tmp_path)
    unit, items, what = span_ab.cell_units(layout.cell(cell, root), 11, CPU)
    assert what in ("batch", "step") and items > 0
    blocks, spans = span_ab.ab(unit, obs.RECORDER, pairs=1, units=1, seed=3,
                               dev=CPU)
    out = span_ab.compare(blocks)
    assert out["units"]["on"] + len(out["gc_pauses_ms"]["on"]) == 1
    assert spans > 1 and obs.RECORDER.enabled
