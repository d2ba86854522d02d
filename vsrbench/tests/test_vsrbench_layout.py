"""BENCHMARK.json and the files it names: every cell resolves by name, and
a configuration, a traffic mix and a metric added as new files are found
with no edit to a file that is there."""
from __future__ import annotations

import importlib
import json
import re
import shutil

import pytest

from vsrbench import harness, layout
from vsrbench.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    c = layout.cell(cell)
    assert c.config and c.traffic and c.limits
    importlib.import_module("vsrbench.drivers." + c.traffic["driver"])
    assert c.end_to_end and any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.per_layer:
        assert hasattr(harness.load_metric(c.metric_file(m["name"])), "read")


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    cells = [w["name"] for w in b["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for name in names + cells + [m["name"] for m in metrics]:
        assert NAME.match(name), name
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", cells):
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_added_files_are_found(tmp_path):
    """A new configuration, traffic mix, metric and limits, as new files
    and new entries in BENCHMARK.json, resolve without touching the
    files that are there."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "vsrbench").rglob("*")
              if p.is_file()}
    vb = root / "vsrbench"
    shutil.copy(vb / "configs" / "vsr-coco.json", vb / "configs" /
                "vsr-extra.json")
    shutil.copy(vb / "traffic" / "stream-b512.json", vb / "traffic" /
                "stream-extra.json")
    shutil.copy(vb / "limits" / "vsr-coco.stream-b512.json", vb / "limits" /
                "vsr-extra.stream-extra.json")
    (vb / "metrics" / "launches_per_batch.eval.py").write_text(
        "def read(ctx):\n    return 20.0\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="vsr-extra",
                             file="vsrbench/configs/vsr-extra.json"))
    b["workloads"].append({"name": "vsr-extra.stream-extra",
                           "config": "vsr-extra", "traffic": "stream-extra",
                           "chips": 1, "why": "added as files"})
    b["per_layer"].append({"name": "launches_per_batch.eval", "unit": "count",
                           "better": "lower", "source": "program_counter",
                           "layer": "kernels", "moves": "captions_per_s",
                           "workloads": ["vsr-extra.stream-extra"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "vsr-coco.stream-b512" in m["workloads"]:
            m["workloads"].append("vsr-extra.stream-extra")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = layout.cell("vsr-extra.stream-extra", root)
    assert c.traffic["driver"] == "eval_stream"
    assert [m["name"] for m in c.per_layer] == ["launches_per_batch.eval"]
    assert harness.load_metric(
        c.metric_file("launches_per_batch.eval")).read(None) == 20.0
    assert all(p.read_bytes() == data for p, data in before.items())


def test_unknown_cell_exits():
    with pytest.raises(SystemExit):
        layout.cell("no-such.cell")
