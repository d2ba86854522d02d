"""Write the three checkpoints the eval CLI loads (captioner, S-SSP planner,
Sinkhorn net), as npz with their cfg blocks, from seeded random weights.

    python3 -m vsrcic_tpu_torch.tools.eval_checkpoints OUT_DIR [eval flags]

The captioner's width and vocabulary come from the eval flags given (the
world they build: `--dataset`, `--synthetic`, `--synthetic_images`,
`--seed`, `--feat_dim`, `--input_encoding_size`, `--rnn_size`,
`--att_size`), the planner's from `--ssp_hidden_size`, `--ssp_embed_size`
and `--ssp_layers`; the Sinkhorn net is `SinkhornConfig(vis_dim=feat_dim)`.
The weights are the models' own initialisers driven by
`torch.Generator`s seeded with 0, 1 and 2. The cfg blocks
are those the JAX package's train CLIs write, so both packages' eval CLIs
load these files. Prints the `--*_ckpt` flags to hand the eval CLI.

`golden_flags` writes the checkpoints that the eval CLI's golden fixture
(`testdata/golden_eval_cli.npz`, written by `python tests/torch_parity.py
--eval-cli`) holds, and returns the flags of the run that made its dumps;
`run_captured` runs an eval CLI with its output captured; `lines_match`
compares printed metric lines.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from vsrcic_tpu_torch.cli.common import base_parser, build_world
from vsrcic_tpu_torch.core.checkpoint import _save_npz, save_checkpoint
from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                               init_captioner_params)
from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                              init_sinkhorn_params)
from vsrcic_tpu_torch.utils.params import params_to_numpy


GOLDEN = (Path(__file__).resolve().parent.parent / "testdata"
          / "golden_eval_cli.npz")
NAMES = ("captioner", "ssp", "sinkhorn")


def parser():
    p = base_parser()
    p.add_argument("--ssp_hidden_size", default=512, type=int)
    p.add_argument("--ssp_embed_size", default=512, type=int)
    p.add_argument("--ssp_layers", default=3, type=int)
    return p


def _np(x):
    return np.asarray(x)


def checkpoint_trees(argv: Sequence[str]) -> Dict[str, dict]:
    """{"captioner", "ssp", "sinkhorn"}: the checkpoint trees (numpy
    leaves) for the world that `argv` (eval CLI flags) builds."""
    opt, _ = parser().parse_known_args(list(argv))
    tf = build_world(opt).text_field
    cap = CaptionerConfig(seq_len=20, vocab_size=len(tf.vocab),
                          bos_idx=tf.bos_idx, det_feat_size=opt.feat_dim,
                          input_encoding_size=opt.input_encoding_size,
                          rnn_size=opt.rnn_size, att_size=opt.att_size)
    ssp = SSPConfig(dataset=opt.dataset, hidden_size=opt.ssp_hidden_size,
                    embed_size=opt.ssp_embed_size,
                    encoder_layers=opt.ssp_layers,
                    decoder_layers=opt.ssp_layers)
    sink = SinkhornConfig(vis_dim=opt.feat_dim)

    def gen(k):
        return torch.Generator().manual_seed(k)

    return {
        "captioner": {
            "params": params_to_numpy(init_captioner_params(gen(0), cap)),
            "cfg": {f: _np(getattr(cap, f)) for f in (
                "seq_len", "vocab_size", "bos_idx", "det_feat_size",
                "input_encoding_size", "rnn_size", "att_size",
                "h2_first_lstm", "img_second_lstm")}},
        "ssp": {
            "params": params_to_numpy(init_ssp_params(gen(1), ssp)),
            "cfg": {"dataset_id": _np(0 if opt.dataset == "coco" else 1),
                    "hidden_size": _np(ssp.hidden_size),
                    "embed_size": _np(ssp.embed_size),
                    "encoder_layers": _np(ssp.encoder_layers),
                    "decoder_layers": _np(ssp.decoder_layers),
                    "max_len": _np(ssp.max_len)}},
        "sinkhorn": {
            "params": params_to_numpy(init_sinkhorn_params(gen(2), sink)),
            "cfg": {f: _np(getattr(sink, f)) for f in (
                "n", "n_iters", "tau", "txt_dim", "vis_dim", "pos_dim")}},
    }


def write(out_dir: str, trees: Dict[str, dict]) -> List[str]:
    """Save each tree as `out_dir`/<name>.npz; returns the eval CLI's
    checkpoint flags for them."""
    flags = []
    for name, tree in trees.items():
        path = os.path.join(out_dir, name)
        save_checkpoint(path, tree)
        flags += ["--%s_ckpt" % name, path + ".npz"]
    return flags


def load_golden(path=GOLDEN) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def golden_ckpt_prefix(dataset: str, name: str) -> str:
    """Where the golden fixture holds a checkpoint's flat keys: the
    Sinkhorn net is the same for both worlds and held once."""
    return ("ckpt/%s/" % name if name == "sinkhorn"
            else "%s/ckpt/%s/" % (dataset, name))


def golden_flags(golden: Dict[str, np.ndarray], dataset: str,
                 out_dir: str) -> List[str]:
    """Write `dataset`'s checkpoints from the golden fixture into `out_dir`
    (its f16 weights widened to f32, exactly) and return the eval CLI
    flags of the fixture's run, checkpoints included (no --platform, no
    mode flags, no --dump_preds)."""
    flags = ["--dataset", dataset] + json.loads(str(golden["argv"]))
    for name in NAMES:
        pre = golden_ckpt_prefix(dataset, name)
        tree = {k[len(pre):]: (v.astype(np.float32) if v.dtype == np.float16
                               else v)
                for k, v in golden.items() if k.startswith(pre)}
        path = os.path.join(out_dir, dataset, name + ".npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # the keys are already flat ("params/a/b"): _flatten keeps them
        _save_npz(path, tree)
        flags += ["--%s_ckpt" % name, path]
    return flags


def lines_match(got: List[str], want: List[str]) -> bool:
    """Equal printed metric lines, except that a host without nltk's
    stemmer prints 'METEOR unavailable: ...' where the other scored
    natively."""
    return len(got) == len(want) and all(
        g == w or (g.startswith("METEOR unavailable")
                   and w.startswith("METEOR(native)"))
        for g, w in zip(got, want))


def run_captured(main, argv, dump):
    """An eval CLI's main(argv + --dump_preds dump) with its standard output
    captured. Returns ({"cider", "n" (captions decoded), "metrics" (the
    lines after the 'decoded' line), "dump" (the dumped JSON lines)},
    the 'decoded N captions in T s (R captions/s)' line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cider = main(list(argv) + ["--dump_preds", str(dump)])
    lines = buf.getvalue().splitlines()
    at = [i for i, line in enumerate(lines) if line.startswith("decoded ")]
    if len(at) != 1:
        raise AssertionError("the eval CLI printed no single 'decoded' line:"
                             "\n" + "\n".join(lines[-20:]))
    with open(dump) as f:
        dumped = f.read()
    return ({"cider": float(cider), "n": int(lines[at[0]].split()[1]),
             "metrics": lines[at[0] + 1:], "dump": dumped}, lines[at[0]])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    print(" ".join(write(argv[0], checkpoint_trees(argv[1:]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
