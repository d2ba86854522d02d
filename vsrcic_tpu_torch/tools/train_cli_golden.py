"""The train CLIs' golden fixture (`testdata/golden_train_cli.npz`) and how to
replay it.

The fixture holds, for three runs of the JAX package's train CLIs on the
synthetic worlds at tiny widths (`ARGV`): XE on COCO (`xe`), and the
Sinkhorn planner on COCO ('images' normalisation) and on Flickr ('pairs'):
  * the initial checkpoint each run resumes from (`--start_from`), written
    from `jax.random` weights rounded to f16 so that the fixture holds them
    as f16 exactly (the Sinkhorn net's is the same for both worlds and held
    once);
  * the per-step `train_loss` records of its `--log_dir` journal;
  * the checkpoint it saved: every weight of the captioner, a strided
    sample of at most `SAMPLE` entries of each Sinkhorn weight;
  * XE's validation lines (Bleu_1..4, METEOR, ROUGE_L, val CIDEr).

`python tests/torch_parity.py --train-cli` writes it. `golden_flags`
writes a run's initial checkpoint into a directory and returns the argv of
the fixture's run there; `run_captured` runs a train CLI with its output
captured; `check_run` holds a run's results to another's (losses within
rtol 1e-4, saved weights within rtol 1e-4 / atol 1e-6, validation lines
equal). `first_staged_batch` and `check_staged` hold the batch the train
CLI's loader staged on the device to the host's arrays.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from vsrcic_tpu_torch.core.checkpoint import _flatten, _load_npz, _save_npz
from vsrcic_tpu_torch.tools.eval_checkpoints import lines_match

GOLDEN = (Path(__file__).resolve().parent.parent / "testdata"
          / "golden_train_cli.npz")

# tests/test_cli_lifecycle.py's tiny widths on 16 synthetic images (two
# batches of 8 an epoch), with 32-d features; three steps over two epochs
ARGV = ["--synthetic", "--synthetic_images", "16", "--batch_size", "8",
        "--seed", "7", "--rnn_size", "16", "--att_size", "8",
        "--input_encoding_size", "16", "--feat_dim", "32",
        "--max_epochs", "2", "--max_steps", "3"]
# run -> (CLI module, --dataset, the checkpoint it resumes and saves,
# relative to --checkpoint_path)
RUNS = {"xe": ("train", "coco", "coco_cap/exp_last"),
        "sinkhorn_coco": ("train_sinkhorn", "coco", "coco_sinkhorn/model-sh"),
        "sinkhorn_flickr": ("train_sinkhorn", "flickr",
                            "flickr_sinkhorn/model-sh")}
SAMPLE = 2048
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_PREFIXES = ("Bleu_", "METEOR", "ROUGE_L", "restored ")


def load_golden(path=GOLDEN) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def init_prefix(run: str) -> str:
    """Where the fixture holds a run's initial checkpoint: the Sinkhorn
    runs share one."""
    return "sinkhorn/init/" if run.startswith("sinkhorn") else run + "/init/"


def argv_for(run: str, root: str) -> List[str]:
    """The run's CLI flags with `root` as its checkpoint and log root."""
    _, dataset, ckpt = RUNS[run]
    return (["--dataset", dataset] + ARGV
            + ["--checkpoint_path", root,
               "--start_from", os.path.join(root, os.path.dirname(ckpt)),
               "--log_dir", os.path.join(root, "log")])


def write_init(root: str, run: str, flat: Dict[str, np.ndarray]):
    """Write the flat checkpoint `flat` ("params/a/b" keys) where `run`
    resumes from under `root`."""
    path = os.path.join(root, RUNS[run][2] + ".npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save_npz(path, flat)   # the keys are already flat: _flatten keeps them


def init_flat(golden: Dict[str, np.ndarray], run: str):
    """`run`'s initial checkpoint in the fixture, flat, its f16 weights
    widened to f32 (exactly)."""
    pre = init_prefix(run)
    return {k[len(pre):]: (v.astype(np.float32) if v.dtype == np.float16
                           else v)
            for k, v in golden.items() if k.startswith(pre)}


def golden_flags(golden: Dict[str, np.ndarray], run: str,
                 root: str) -> List[str]:
    """Write `run`'s initial checkpoint from the fixture under `root` and
    return the run's argv (no --platform)."""
    write_init(root, run, init_flat(golden, run))
    return argv_for(run, root)


def journal(log_dir: str) -> List[dict]:
    """The `train_loss` records of a CLI's `--log_dir` journal."""
    with open(os.path.join(log_dir, "train.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train_loss" in r]


def run_captured(main, argv: Sequence[str]) -> dict:
    """A train CLI's main(argv) with its standard output captured:
    {"losses" (the journal's train_loss per step), "steps", "t" (the
    records' times), "lines" (the printed validation and restore lines),
    "out" (every printed line)}."""
    argv = list(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue().splitlines()
    recs = journal(argv[argv.index("--log_dir") + 1])
    return {"losses": [r["train_loss"] for r in recs],
            "steps": [r["step"] for r in recs],
            "t": [r["t"] for r in recs],
            "lines": [ln for ln in out if ln.startswith(METRIC_PREFIXES)
                      or " val CIDEr " in ln],
            "out": out}


def sample(x: np.ndarray) -> np.ndarray:
    """At most SAMPLE entries of x, strided over its flat view."""
    flat = np.asarray(x).reshape(-1)
    return flat[::max(1, -(-flat.size // SAMPLE))]


def saved_params(root: str, run: str) -> Dict[str, np.ndarray]:
    """The weights `run` saved under `root`, flat ("params/a/b" keys);
    the Sinkhorn net's as strided samples."""
    flat = {k: v for k, v in _flatten(_load_npz(os.path.join(
        root, RUNS[run][2]))).items() if k.startswith("params/")}
    if run.startswith("sinkhorn"):
        flat = {k: sample(v) for k, v in flat.items()}
    return flat


def check_run(what: str, got: dict, got_params: Dict[str, np.ndarray],
              want_losses, want_params: Dict[str, np.ndarray],
              want_lines: List[str]) -> dict:
    """Raise AssertionError unless `got` (run_captured's) has want's
    losses within LOSS_RTOL, `got_params` want's within PARAM_TOL (same
    keys, shapes) and its lines equal want's (lines_match). Returns the
    largest relative loss difference and absolute weight difference."""
    want_losses = np.asarray(want_losses, np.float64)
    losses = np.asarray(got["losses"], np.float64)
    if losses.shape != want_losses.shape or not np.allclose(
            losses, want_losses, rtol=LOSS_RTOL, atol=0):
        raise AssertionError("%s: losses %s, want %s (rtol %g)"
                             % (what, losses.tolist(), want_losses.tolist(),
                                LOSS_RTOL))
    if sorted(got_params) != sorted(want_params):
        raise AssertionError("%s: saved weights %s, want %s" % (
            what, sorted(got_params), sorted(want_params)))
    worst = 0.0
    for k, w in want_params.items():
        g = np.asarray(got_params[k], np.float32)
        if g.shape != w.shape or not np.allclose(g, w, **PARAM_TOL):
            raise AssertionError(
                "%s: saved %s beyond rtol %g / atol %g (max diff %s)"
                % (what, k, PARAM_TOL["rtol"], PARAM_TOL["atol"],
                   np.abs(g - w).max() if g.shape == w.shape else g.shape))
        worst = max(worst, float(np.abs(g - w).max(initial=0.0)))
    if not lines_match(got["lines"], list(want_lines)):
        raise AssertionError("%s: lines\n%s\nwant\n%s" % (
            what, "\n".join(got["lines"]), "\n".join(want_lines)))
    return {"loss_rel_diff": float(np.max(
        np.abs(losses - want_losses) / np.abs(want_losses), initial=0.0)),
        "param_max_diff": worst}


def golden_run(golden: Dict[str, np.ndarray], run: str):
    """(losses, saved weights, lines) of `run` in the fixture."""
    pre = run + "/saved/"
    return (golden[run + "/losses"],
            {k[len(pre):]: v for k, v in golden.items()
             if k.startswith(pre)},
            json.loads(str(golden[run + "/lines"])))


def _leaves(tree, keep):
    """The leaves of nested dicts, lists and tuples that `keep` accepts, in
    `cuda_put`'s walk order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v, keep)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, keep)]
    return [tree] if keep(tree) else []


@contextlib.contextmanager
def first_staged_batch():
    """For the block, `data.loader.cuda_put` (which the train CLI hands its
    `DevicePrefetchLoader`) records the first batch it stages. Yields a
    dict that then holds "host" (copies of that batch's numeric arrays)
    and "staged" (the tensors cuda_put made of them), in walk order."""
    import torch
    from vsrcic_tpu_torch.data import loader
    put = loader.cuda_put
    seen: dict = {}

    def recording(batch, device):
        out = put(batch, device)
        if not seen:
            seen["host"] = [np.array(a) for a in _leaves(
                batch, lambda x: isinstance(x, np.ndarray)
                and x.dtype.kind in "biufc")]
            seen["staged"] = _leaves(out,
                                     lambda x: isinstance(x, torch.Tensor))
        return out

    loader.cuda_put = recording
    try:
        yield seen
    finally:
        loader.cuda_put = put


def check_staged(seen: dict) -> int:
    """Raise AssertionError unless every staged tensor holds its host
    array's dtype, shape and bytes; returns the bytes compared."""
    host, staged = seen["host"], seen["staged"]
    if not host or len(host) != len(staged):
        raise AssertionError("staged %d tensors for %d host arrays"
                             % (len(staged), len(host)))
    n = 0
    for i, (h, t) in enumerate(zip(host, staged)):
        d = t.detach().cpu().numpy()
        if d.dtype != h.dtype or d.shape != h.shape or \
                d.tobytes() != h.tobytes():
            raise AssertionError("staged array %d (%s %s) is not the host's "
                                 "(%s %s)" % (i, d.dtype, d.shape, h.dtype,
                                              h.shape))
        n += h.nbytes
    return n
