"""Finds everything a cell needs by name, with no list to edit.

From `BENCHMARK.json` at the root: the cell's configuration and traffic
names and the metrics that apply to it. Then, under `vsrbench/` at the
same root:

  * `configs/<config>.json`: the configuration (its `driver` group names
    how it is built and run);
  * `traffic/<traffic>.json`: the traffic mix's parameters, read by the
    general generator `drivers/<driver>.py` that it names;
  * `metrics/<metric>.py`: a per-layer metric's reader and arithmetic;
  * `limits/<workload>.json`: the limits of the cell's output checks.

A later cell, configuration, traffic mix or metric is a new file here and
a new entry in `BENCHMARK.json`.
"""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Cell:
    def __init__(self, root, bench, workload):
        self.root = Path(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit("vsrbench: no workload %r in BENCHMARK.json "
                             "(%s)" % (workload, ", ".join(sorted(cells))))
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        self.config = self._json("configs", self.workload["config"])
        self.traffic = self._json("traffic", self.workload["traffic"])
        self.limits = self._json("limits", workload)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"]
                              if "workloads" in m else m["moves"] in e2e)]
        for m in self.per_layer:
            self.metric_file(m["name"])

    def _json(self, folder, name):
        path = self.root / "vsrbench" / folder / (name + ".json")
        if not path.is_file():
            raise SystemExit("vsrbench: %s is missing" % path)
        with open(path) as f:
            return json.load(f)

    def metric_file(self, name):
        path = self.root / "vsrbench" / "metrics" / (name + ".py")
        if not path.is_file():
            raise SystemExit("vsrbench: %s is missing" % path)
        return path


def load(root=None):
    root = Path(root or ROOT)
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit("vsrbench: %s is missing" % path)
    with open(path) as f:
        return root, json.load(f)


def cell(workload, root=None):
    root, bench = load(root)
    return Cell(root, bench, workload)
