"""Offline wrappers for Java-based metrics (METEOR, SPICE).

A copy of `vsrcic_tpu/metrics/external.py` (numpy only): the port imports nothing
of the JAX package, not even its JAX-free modules.

The reference invokes these via speaksee's bundled jars only at eval time
(reference coco_scripts/eval_coco.py:277,286). They require Java + data files
that are not re-implementable natively (alignment/paraphrase tables, scene
graphs), so this module shells out to user-provided jars when configured via
environment variables and otherwise reports unavailability explicitly instead
of silently skipping.

  VSRCIC_METEOR_JAR  — path to meteor-1.5.jar
  VSRCIC_SPICE_JAR   — path to spice-1.0.jar
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np


class ExternalMetricUnavailable(RuntimeError):
    pass


class Meteor:
    def __init__(self, jar: Optional[str] = None, language: str = "en"):
        self.jar = jar or os.environ.get("VSRCIC_METEOR_JAR")
        self.language = language

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        if not self.jar or not os.path.isfile(self.jar):
            raise ExternalMetricUnavailable(
                "METEOR requires meteor-1.5.jar (set VSRCIC_METEOR_JAR); "
                "jar-based metric is eval-only and optional")
        keys = list(gts.keys())
        with tempfile.TemporaryDirectory() as td:
            tst = os.path.join(td, "tst")
            ref = os.path.join(td, "ref")
            n_refs = max(len(gts[k]) for k in keys)
            with open(tst, "w") as ft, open(ref, "w") as fr:
                for k in keys:
                    ft.write((res[k][0] if isinstance(res[k], (list, tuple))
                              else res[k]) + "\n")
                    refs = list(gts[k]) + [gts[k][-1]] * (n_refs - len(gts[k]))
                    for r in refs:
                        fr.write(r + "\n")
            out = subprocess.run(
                ["java", "-jar", self.jar, tst, ref, "-l", self.language,
                 "-norm", "-r", str(n_refs)],
                capture_output=True, text=True, check=True).stdout
        seg_scores = []
        final = 0.0
        for line in out.splitlines():
            if line.startswith("Segment") and "score:" in line:
                seg_scores.append(float(line.split()[-1]))
            elif line.startswith("Final score:"):
                final = float(line.split()[-1])
        return final, np.array(seg_scores)


class Spice:
    def __init__(self, jar: Optional[str] = None):
        self.jar = jar or os.environ.get("VSRCIC_SPICE_JAR")

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        if not self.jar or not os.path.isfile(self.jar):
            raise ExternalMetricUnavailable(
                "SPICE requires spice-1.0.jar (set VSRCIC_SPICE_JAR); "
                "jar-based metric is eval-only and optional")
        keys = list(gts.keys())
        with tempfile.TemporaryDirectory() as td:
            inp = os.path.join(td, "in.json")
            outp = os.path.join(td, "out.json")
            with open(inp, "w") as f:
                json.dump([{"image_id": str(k),
                            "test": (res[k][0] if isinstance(res[k], (list, tuple))
                                     else res[k]),
                            "refs": list(gts[k])} for k in keys], f)
            subprocess.run(["java", "-jar", self.jar, inp, "-out", outp,
                            "-subset", "-silent"], check=True)
            with open(outp) as f:
                results = json.load(f)
        scores = np.array([item["scores"]["All"]["f"] for item in results])
        return float(np.mean(scores)), scores
