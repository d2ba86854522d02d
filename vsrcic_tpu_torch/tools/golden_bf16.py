"""The beam's bf16 modes: their golden fixture
(`testdata/golden_beam_bf16.npz`) and how to replay it.

The fixture holds JAX's `beam_search_v` (beam 5, Pallas kernels in
interpret mode) at bench.py's configuration cut to small widths (`CFG`:
R 40 is not a multiple of the bf16 kernel's 16-deep products), on inputs
with padded regions and verb slots, for each path of `PATHS`:
  * `lhs_bf16`: fused attention and vocab top-k on bf16 tables, under
    VSRCIC_VOCAB_LHS_BF16=1 (on the card: the vocab head's tensor-core
    kernel);
  * `lhs_bf16_f32_tables`: the same on f32 tables (h2 rounded to bf16, then
    the f32 product);
  * `decode_bf16_strict`: decode_dtype=bfloat16, no kernel;
  * `decode_bf16_fast`: decode_dtype=bfloat16 with both kernels, the
    tables in the decode dtype.
The weights are not stored: both packages draw them from numpy's seed
`PARAM_SEED` (`utils.params.seeded_params`, over the captioner's keys and
shapes), biases included.

`python tests/torch_parity.py --bf16` writes it; `replay` runs one path
through the port.
"""
from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path

import numpy as np
import torch

GOLDEN = (Path(__file__).resolve().parent.parent / "testdata"
          / "golden_beam_bf16.npz")
LHS_BF16 = "VSRCIC_VOCAB_LHS_BF16"
CFG = dict(seq_len=12, vocab_size=200, bos_idx=2, det_feat_size=48,
           input_encoding_size=32, rnn_size=40, att_size=24)
VERB_TABLE = {"1": [5, 9, 11], "2": [7], "3": []}
B, L, M, N_DET = 6, 6, 5, 10
BEAM, EOS = 5, 3
PARAM_SEED, INPUT_SEED = 11, 3
# path -> (kernels' table dtype: None strict, "f32" or "bf16"; decode in
# bf16; VSRCIC_VOCAB_LHS_BF16 on)
PATHS = {"lhs_bf16": ("bf16", False, True),
         "lhs_bf16_f32_tables": ("f32", False, True),
         "decode_bf16_strict": (None, True, False),
         "decode_bf16_fast": ("f32", True, False)}


@contextlib.contextmanager
def lhs_bf16(on: bool):
    """VSRCIC_VOCAB_LHS_BF16 set to "1" (on) or unset for the block."""
    saved = os.environ.get(LHS_BF16)
    if on:
        os.environ[LHS_BF16] = "1"
    else:
        os.environ.pop(LHS_BF16, None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(LHS_BF16, None)
        else:
            os.environ[LHS_BF16] = saved


def inputs(seed: int = INPUT_SEED):
    """(detections (B, N, D), det_groups (B, L, M, D), verb_list (B, L)):
    detections past the 7th and regions past the 4th zero; verbs with
    tenses, one with none (word 0), and verbs in the first group."""
    rng = np.random.RandomState(seed)
    d = CFG["det_feat_size"]
    detections = rng.rand(B, N_DET, d).astype(np.float32)
    detections[:, 7:] = 0.0
    groups = rng.rand(B, L, M, d).astype(np.float32)
    groups[:, :, 4:] = 0.0
    verb_list = np.full((B, L), -1, np.int64)
    for (b, l), v in {(0, 1): 1, (1, 2): 2, (2, 0): 3, (3, 0): 1,
                      (4, 3): 2, (5, 1): 1}.items():
        verb_list[b, l] = v
    return detections, groups, verb_list


def params(seed: int = PARAM_SEED):
    """The fixture's weights: numpy arrays over the port captioner's keys
    and shapes (the JAX package's are the same)."""
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.utils.params import seeded_params
    template = init_captioner_params(torch.Generator().manual_seed(0),
                                     CaptionerConfig(**CFG))
    return seeded_params(template, seed)


def load():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def replay(g, path: str, device):
    """`path`'s beam on the fixture's inputs through the port on `device`
    (the kernels on the card, their plain versions on the CPU), under the
    path's VSRCIC_VOCAB_LHS_BF16; a BeamResult."""
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    cfg = json.loads(str(g["config"]))
    if cfg != CFG or int(g["param_seed"]) != PARAM_SEED:
        raise ValueError("golden_beam_bf16.npz was written for %s, seed %d"
                         % (cfg, int(g["param_seed"])))
    table, decode_bf16, lhs = PATHS[path]
    kw = {}
    if table is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  table_dtype=torch.bfloat16 if table == "bf16" else None)
    cap = ControllableCaptioner(
        CaptionerConfig(**CFG), params=params(), verb_2_vob_all=VERB_TABLE,
        device=device, decode_dtype=torch.bfloat16 if decode_bf16 else None,
        **kw)
    with lhs_bf16(lhs):
        return cap.beam_search_v(g["detections"], g["det_groups"],
                                 g["verb_list"], eos_word=int(g["eos_word"]),
                                 beam_size=int(g["beam_size"]))
