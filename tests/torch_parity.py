"""Shared fixtures of the port's parity tests (tests/test_torch_*.py), and
the writer of the port's golden fixture.

The inputs are those of tests/test_vocab_topk.py: a verb in the first
group, an empty tense list, padded regions and short sequences that force
finished beams. Parameters are made by the JAX package and reach the port
through its weight bridge (`vsrcic_tpu_torch.utils.params`).

    python tests/torch_parity.py   # rewrite vsrcic_tpu_torch/testdata/golden_beam.npz
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

V, D, E, R, A = 30, 32, 24, 16, 8
T, B, M, L = 12, 4, 5, 6
BOS, EOS = 2, 3
VERB_TABLE = {"1": [5, 9, 11], "2": [7], "3": []}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "vsrcic_tpu_torch", "testdata", "golden_beam.npz")
GOLDEN_SEED, GOLDEN_BEAM = 2, 5
RESULT_FIELDS = ("words", "gates", "word_logps", "gate_logps", "scores")


@pytest.fixture
def cuda_device():
    """The CUDA card, with TF32 off for matmuls and convolutions (the JAX
    tests run at 'highest' precision); skips where there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(seed, gt=False):
    rng = np.random.RandomState(seed)
    detections = rng.rand(B, 10, D).astype(np.float32)
    detections[:, 7:] = 0.0
    groups = rng.rand(B, L, M, D).astype(np.float32)
    groups[:, :, 4:] = 0.0
    verb_list = np.full((B, L), -1, np.int64)
    verb_list[0, 1] = 1
    verb_list[1, 2] = 2
    verb_list[2, 0] = 3     # empty tense list -> fallback word 0
    verb_list[3, 0] = 1     # verb in the FIRST group (t=0 substitution)
    if gt:
        verb_list = np.where(verb_list > 0, 7, verb_list)
    return detections, groups, verb_list


# shapes of tests/test_fused_attention.py
FA_B, FA_L, FA_D, FA_A, FA_K = 3, 4, 32, 16, 2
FA_ROWS = FA_B * FA_K


def fused_inputs(m, seed=0, rows=FA_ROWS, b=FA_B, d=FA_D, a=FA_A):
    rng = np.random.RandomState(seed)
    det_groups = rng.rand(b, FA_L, m, d).astype(np.float32)
    det_groups[:, :, 4:] = 0.0  # padded regions
    groups_proj = rng.randn(b, FA_L, m, a).astype(np.float32)
    item = (np.arange(rows) * b // rows).astype(np.int32)
    ctrl = rng.randint(0, FA_L, rows).astype(np.int32)
    ha = rng.randn(rows, a).astype(np.float32)
    sent_w = rng.randn(rows, 1).astype(np.float32)
    sent_mask = (rng.rand(rows, 1) < 0.8).astype(np.float32)
    fc_sent = rng.randn(rows, d).astype(np.float32)
    att_a = rng.randn(a).astype(np.float32)
    return (item, ctrl, ha, sent_w, sent_mask, fc_sent, att_a, det_groups,
            groups_proj)


def fused_torch_args(args, table_dtype, device="cpu"):
    import torch
    out = [torch.from_numpy(x).to(device) for x in args]
    out[7] = out[7].to(table_dtype)
    out[8] = out[8].to(table_dtype)
    return out


def vocab_case(name):
    """(h2, w_t, bias, k, make_vocab_topk_lse kwargs) as numpy."""
    if name == "ties":
        # duplicate columns, and a same-lane-position tie 128 columns apart
        rng = np.random.RandomState(0)
        rows, r, v, k = 16, 24, 300, 5
        pairs, kw = ((3, 10), (42, 170)), dict(tile_v=128)
    elif name == "multi_chunk":
        rng = np.random.RandomState(5)
        rows, r, v, k = 8, 16, 700, 5
        pairs, kw = ((3, 131), (40, 296), (512, 640)), dict(tile_v=256)
    else:  # row-blocked grid
        rng = np.random.RandomState(2)
        rows, r, v, k = 24, 16, 260, 4
        pairs, kw = (), dict(tile_v=128, tile_rows=8)
    h2 = rng.randn(rows, r).astype(np.float32)
    w_t = rng.randn(r, v).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    for a, c in pairs:
        w_t[:, c] = w_t[:, a]
        b[c] = b[a]
    return h2, w_t, b, k, kw


def jax_cfg():
    from vsrcic_tpu.models.captioner import CaptionerConfig
    return CaptionerConfig(seq_len=T, vocab_size=V, bos_idx=BOS,
                           det_feat_size=D, input_encoding_size=E,
                           rnn_size=R, att_size=A)


def torch_cfg():
    from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    return CaptionerConfig(seq_len=T, vocab_size=V, bos_idx=BOS,
                           det_feat_size=D, input_encoding_size=E,
                           rnn_size=R, att_size=A)


def jax_params(seed=0):
    import jax
    from vsrcic_tpu.models.captioner import init_captioner_params
    return init_captioner_params(jax.random.PRNGKey(seed), jax_cfg())


def to_numpy_tree(tree):
    return {k: (to_numpy_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def jax_captioner(params, fast=None, step_bf16=False):
    """fast: None (strict), "f32" or "bf16" (fused attention + vocab top-k
    through the Pallas kernels in interpret mode, with that table dtype).
    step_bf16: store the big fused step weights in bf16 (step_dtype)."""
    import jax.numpy as jnp
    from vsrcic_tpu.models.api import ControllableCaptioner
    kw = {}
    if fast is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  pallas_interpret=True,
                  table_dtype=jnp.bfloat16 if fast == "bf16" else None,
                  step_dtype=jnp.bfloat16 if step_bf16 else None)
    return ControllableCaptioner(jax_cfg(), params=params,
                                 verb_2_vob_all=VERB_TABLE, **kw)


def torch_captioner(params_np, fast=None, device="cpu", step_bf16=False):
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.utils.params import params_from_jax
    kw = {}
    if fast is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  table_dtype=torch.bfloat16 if fast == "bf16" else None,
                  step_dtype=torch.bfloat16 if step_bf16 else None)
    return ControllableCaptioner(torch_cfg(),
                                 params=params_from_jax(params_np, device),
                                 verb_2_vob_all=VERB_TABLE, device=device,
                                 **kw)


def result_arrays(res):
    out = {}
    for f in RESULT_FIELDS:
        x = getattr(res, f)
        x = x.detach().cpu().numpy() if hasattr(x, "detach") else \
            np.asarray(x)
        out[f] = x.astype(np.int64) if f in ("words", "gates") else x
    return out


def assert_beams_match(got, want):
    """Words and gates identical; logprobs and scores within rtol 1e-5,
    atol 1e-6."""
    got, want = result_arrays(got), result_arrays(want)
    np.testing.assert_array_equal(got["words"], want["words"])
    np.testing.assert_array_equal(got["gates"], want["gates"])
    for f in ("scores", "word_logps", "gate_logps"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def golden_arrays():
    """The golden fixture's contents, computed by the JAX package."""
    from vsrcic_tpu_torch.utils.params import flatten
    params = to_numpy_tree(jax_params())
    detections, groups, verb_list = inputs(GOLDEN_SEED)
    out = {"param/" + k: v for k, v in flatten(params).items()}
    out.update(detections=detections, det_groups=groups, verb_list=verb_list,
               beam_size=np.int64(GOLDEN_BEAM), eos_word=np.int64(EOS),
               verb_table=np.array(json.dumps(VERB_TABLE, sort_keys=True)),
               config=np.array(json.dumps(dict(
                   seq_len=T, vocab_size=V, bos_idx=BOS, det_feat_size=D,
                   input_encoding_size=E, rnn_size=R, att_size=A),
                   sort_keys=True)))
    for name, fast in (("strict", None), ("fast_bf16", "bf16")):
        res = jax_captioner(params, fast).beam_search_v(
            detections, groups, verb_list, eos_word=EOS,
            beam_size=GOLDEN_BEAM)
        for f, x in result_arrays(res).items():
            out[name + "/" + f] = x
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    np.savez_compressed(GOLDEN, **golden_arrays())
    print("wrote", GOLDEN)
