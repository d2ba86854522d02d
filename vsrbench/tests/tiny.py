"""A copy of the benchmark's files at tiny shapes, for runs on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
CELLS = ("vsr-coco.stream-b512", "captioner-coco.xe-b1024")


def _load(*parts):
    with open(REPO.joinpath(*parts)) as f:
        return json.load(f)


def _dump(obj, root, *parts):
    path = Path(root).joinpath(*parts)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def tiny_root(root):
    """BENCHMARK.json and vsrbench/{configs,traffic,limits,metrics} under
    `root`, the cells' configurations and traffic cut to tiny shapes, the
    limits and metrics as committed."""
    root = Path(root)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "vsrbench" / "metrics", root / "vsrbench" /
                    "metrics", ignore=shutil.ignore_patterns("__pycache__"))
    cap = dict(seq_len=6, vocab_size=30, det_feat_size=16,
               input_encoding_size=8, rnn_size=8, att_size=8)
    c = _load("vsrbench", "configs", "vsr-coco.json")
    c["captioner"].update(cap)
    c["planner"].update(encoder_layers=1, decoder_layers=1, hidden_size=16,
                        embed_size=16, n_heads=2)
    c["sinkhorn"].update(txt_dim=6, vis_dim=16)
    c["plan"].update(regions=4, detections=7, n_verbs=50)
    _dump(c, root, "vsrbench", "configs", "vsr-coco.json")
    x = _load("vsrbench", "configs", "captioner-coco.json")
    x["captioner"].update(cap)
    x["data"].update(detections=7, regions=4)
    _dump(x, root, "vsrbench", "configs", "captioner-coco.json")
    t = _load("vsrbench", "traffic", "stream-b512.json")
    t.update(jobs=6, pool=2, trace_wait=1, trace_units=2, check_batches=2,
             judge_block=4, real_detections=[3, 7], regions_per_group=[1, 4])
    _dump(t, root, "vsrbench", "traffic", "stream-b512.json")
    t = _load("vsrbench", "traffic", "xe-b1024.json")
    t.update(batch=8, pool=4, trace_wait=1, trace_units=2, ref_block=3,
             real_detections=[3, 7], caption_words=[1, 4],
             regions_per_step=[1, 4])
    _dump(t, root, "vsrbench", "traffic", "xe-b1024.json")
    for cell in CELLS:
        _dump(_load("vsrbench", "limits", cell + ".json"), root, "vsrbench",
              "limits", cell + ".json")
    return root


def run_cell(root, cell, trace=0, seconds=1.0, seed=4294967311):
    """One run of a cell on the CPU: (exit code, result line as a dict or
    None)."""
    import contextlib
    import io
    from vsrbench import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
