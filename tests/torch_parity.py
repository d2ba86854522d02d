"""Shared fixtures of the port's parity tests (tests/test_torch_*.py), and
the writer of the port's golden fixtures.

The beam inputs are those of tests/test_vocab_topk.py: a verb in the first
group, an empty tense list, padded regions and short sequences that force
finished beams. The eval pipeline's world is the same tiny captioner with a
small planner (hidden 32, 2 + 2 layers) and a narrow Sinkhorn net. The
trainers' world has tests/test_trainers.py's sizes, compact group ids with
-1 padding, and a text field of 26 one-letter words. Parameters are made by
the JAX package and reach the port through its weight bridge
(`vsrcic_tpu_torch.utils.params`).

    python tests/torch_parity.py   # rewrite vsrcic_tpu_torch/testdata/golden_{beam,pipeline,train}.npz
    python tests/torch_parity.py --planners   # golden_planners.npz only
    python tests/torch_parity.py --xe-full-width   # XE losses at full width, both packages
    python tests/torch_parity.py --eval-cli   # golden_eval_cli.npz only
    python tests/torch_parity.py --train-cli   # golden_train_cli.npz only
    python tests/torch_parity.py --bf16   # golden_beam_bf16.npz only

`--eval-cli` writes only the eval CLI's fixture: tiny checkpoints (f16-exact
weights, stored as f16) and what both packages' CLIs print and dump from
them on the synthetic COCO and Flickr worlds. `--planners` writes only the
planner trainers' fixture, so that the three
older fixtures (whose zip timestamps change on every write) stay as they
are. Its weights are not stored: both packages draw them from numpy seeds
(`vsrcic_tpu_torch.utils.params.seeded_params`), and each gradient leaf is
stored as a strided sample of at most GP_GRAD_SAMPLE entries, which keeps
the file under 1 MB at the 2352-d Sinkhorn width. `--train-cli` writes
only the train CLIs' fixture (vsrcic_tpu_torch/tools/train_cli_golden.py
says what it holds).
"""
from __future__ import annotations

import contextlib
import functools
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


def jax_captioner(params, fast=None, step_bf16=False, decode_bf16=False,
                  cfg=None):
    """fast: None (strict), "f32" or "bf16" (fused attention + vocab top-k
    through the Pallas kernels in interpret mode, with that table dtype).
    step_bf16: store the big fused step weights in bf16 (step_dtype).
    decode_bf16: decode_dtype=bfloat16. cfg: CaptionerConfig kwargs (this
    file's small config when None)."""
    import jax.numpy as jnp
    from vsrcic_tpu.models.api import ControllableCaptioner
    from vsrcic_tpu.models.captioner import CaptionerConfig
    kw = {}
    if fast is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  pallas_interpret=True,
                  table_dtype=jnp.bfloat16 if fast == "bf16" else None,
                  step_dtype=jnp.bfloat16 if step_bf16 else None)
    if decode_bf16:
        kw["decode_dtype"] = jnp.bfloat16
    return ControllableCaptioner(
        jax_cfg() if cfg is None else CaptionerConfig(**cfg), params=params,
        verb_2_vob_all=VERB_TABLE, **kw)


def torch_captioner(params_np, fast=None, device="cpu", step_bf16=False,
                    decode_bf16=False):
    import torch
    from vsrcic_tpu_torch.models.api import ControllableCaptioner
    from vsrcic_tpu_torch.utils.params import params_from_jax
    kw = {}
    if fast is not None:
        kw = dict(use_fused_attention=True, use_vocab_topk=True,
                  table_dtype=torch.bfloat16 if fast == "bf16" else None,
                  step_dtype=torch.bfloat16 if step_bf16 else None)
    if decode_bf16:
        kw["decode_dtype"] = torch.bfloat16
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


def assert_beams_match_save_tied(got, want):
    """assert_beams_match, save that the per-step logprobs of two beams of
    an item may be exchanged at a step where both chose the same word and
    gate from parents whose scores tie within f32 rounding. bf16 operands
    make such ties: at step 7 of `inputs(2)` under VSRCIC_VOCAB_LHS_BF16
    the port's two best candidates are 1 ulp apart (-26.54134369,
    -26.54134560), at step 5 of golden_beam_bf16.npz's item 5 under
    decode_dtype bit-equal; JAX's order of each pair is the other one. The
    order of the two rests on the last bit of upstream sums, and with it
    which beam's record holds which parent's logprobs; words, gates and
    scores are held to assert_beams_match's bar all the same."""
    got, want = result_arrays(got), result_arrays(want)
    np.testing.assert_array_equal(got["words"], want["words"])
    np.testing.assert_array_equal(got["gates"], want["gates"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-6, err_msg="scores")
    close = lambda a, b: np.abs(a - b) <= 1e-6 + 1e-5 * np.abs(b)
    for f in ("word_logps", "gate_logps"):
        for i, k, t in np.argwhere(~close(got[f], want[f])):
            peers = [j for j in range(got[f].shape[1])
                     if got["words"][i, j, t] == got["words"][i, k, t]
                     and got["gates"][i, j, t] == got["gates"][i, k, t]
                     and all(close(got[h][i, k, t], want[h][i, j, t])
                             for h in ("word_logps", "gate_logps"))]
            assert peers, "%s differs at %s with no tied peer" % (
                f, (i, k, t))


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


def golden_bf16_arrays():
    """The bf16 modes' fixture (vsrcic_tpu_torch/tools/golden_bf16.py says
    what it holds), computed by the JAX package; the weights are drawn from
    numpy's seed in both packages, over the keys and shapes of JAX's
    init."""
    import jax
    from vsrcic_tpu.models.captioner import (CaptionerConfig,
                                             init_captioner_params)
    from vsrcic_tpu_torch.tools import golden_bf16 as gb
    from vsrcic_tpu_torch.utils.params import seeded_params
    params = seeded_params(to_numpy_tree(init_captioner_params(
        jax.random.PRNGKey(0), CaptionerConfig(**gb.CFG))), gb.PARAM_SEED)
    detections, groups, verb_list = gb.inputs()
    out = dict(detections=detections, det_groups=groups, verb_list=verb_list,
               beam_size=np.int64(gb.BEAM), eos_word=np.int64(gb.EOS),
               param_seed=np.int64(gb.PARAM_SEED),
               config=np.array(json.dumps(gb.CFG, sort_keys=True)))
    assert gb.VERB_TABLE == VERB_TABLE
    for name, (fast, decode_bf16, lhs) in gb.PATHS.items():
        # a new captioner per path: JAX reads the variable when it traces
        with gb.lhs_bf16(lhs):
            res = jax_captioner(params, fast, decode_bf16=decode_bf16,
                                cfg=gb.CFG).beam_search_v(
                detections, groups, verb_list, eos_word=gb.EOS,
                beam_size=gb.BEAM)
            for f, x in result_arrays(res).items():
                out[name + "/" + f] = x
    return out


# ---------------------------------------------------------------------------
# the eval pipeline's world
# ---------------------------------------------------------------------------

GOLDEN_PIPELINE = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                               "golden_pipeline.npz")
SSP_KW = dict(hidden_size=32, embed_size=32, encoder_layers=2,
              decoder_layers=2)
SINK_KW = dict(txt_dim=24, vis_dim=40, pos_dim=4)
PL_L, PL_M, PL_NDET, PL_BEAM = 10, 5, 7, 5
JOB_FIELDS = ("seqs_vis", "seqs_txt", "seqs_pos", "seqs_all",
              "control_verb", "det_seqs_v", "det_seqs_sr", "verb_list")
PLAN_FIELDS = ("P_soft", "preds", "rank_idx", "rank_valid", "verb_lists")


def ssp_cfg(pkg):
    """The small planner config in `pkg` ("jax" or "torch")."""
    if pkg == "jax":
        from vsrcic_tpu.models.s_ssp import SSPConfig
    else:
        from vsrcic_tpu_torch.models.s_ssp import SSPConfig
    return SSPConfig(**SSP_KW)


def sink_cfg(pkg, **kw):
    if pkg == "jax":
        from vsrcic_tpu.models.sinkhorn import SinkhornConfig
    else:
        from vsrcic_tpu_torch.models.sinkhorn import SinkhornConfig
    return SinkhornConfig(**dict(SINK_KW, **kw))


def pipeline_params(seed=0):
    """{captioner, ssp, sinkhorn}: numpy trees made by the JAX package."""
    import jax
    from vsrcic_tpu.models.s_ssp import init_ssp_params
    from vsrcic_tpu.models.sinkhorn import init_sinkhorn_params
    return {"captioner": to_numpy_tree(jax_params(seed)),
            "ssp": to_numpy_tree(init_ssp_params(
                jax.random.PRNGKey(seed + 1), ssp_cfg("jax"))),
            "sinkhorn": to_numpy_tree(init_sinkhorn_params(
                jax.random.PRNGKey(seed + 2), sink_cfg("jax")))}


def empty_job(rng):
    return dict(
        seqs_vis=rng.rand(PL_L, SINK_KW["vis_dim"]).astype(np.float32),
        seqs_txt=rng.rand(PL_L, SINK_KW["txt_dim"]).astype(np.float32),
        seqs_pos=rng.rand(PL_L, SINK_KW["pos_dim"]).astype(np.float32),
        seqs_all=rng.rand(PL_L, PL_M, D).astype(np.float32),
        control_verb=np.zeros(8), det_seqs_v=np.zeros((PL_L, 8)),
        det_seqs_sr=np.zeros((PL_L, 8)), verb_list=np.full((PL_L, 1), -1.0))


def fuzz_job(rng):
    """Random grids (as tests/test_plan_vectorized.py): multi-slot roles
    and merge collisions occur across a few jobs."""
    job = empty_job(rng)
    n_verbs = rng.randint(0, 4)
    if n_verbs:
        job["control_verb"][:n_verbs] = rng.choice(
            np.arange(1.0, 8.0), size=n_verbs, replace=False)
    job["det_seqs_v"] = rng.choice(np.arange(0.0, 8.0), size=(PL_L, 8),
                                   p=[0.5] + [0.5 / 7] * 7)
    job["det_seqs_sr"] = rng.randint(0, 12, size=(PL_L, 8)).astype(float)
    job["verb_list"] = rng.choice([-1.0, 1.0, 2.0, 3.0], size=(PL_L, 1))
    job["seqs_all"][rng.rand(PL_L) < 0.2] = 0.0      # empty region groups
    return job


def pipeline_batch_fields(seed=0):
    """Two batches of jobs (dicts of numpy arrays) and their detections:
    batch 0 has single-verb, multi-verb and fuzzed jobs and a role with more
    than sinkhorn_len slots; batch 1 has no verb groups at all."""
    rng = np.random.RandomState(seed)
    jobs0 = []
    # single verb: a shared-SR pair (Sinkhorn), a unique role, a V slot
    job = empty_job(rng)
    job["control_verb"][0] = 3.0
    job["det_seqs_v"][0:4, 0] = 3.0
    job["det_seqs_sr"][0:4, 0] = (2.0, 2.0, 7.0, 25.0)
    job["verb_list"][3, 0] = 3.0
    jobs0.append(job)
    # two verbs sharing slots (the verb_rank_merge branch)
    job = empty_job(rng)
    job["control_verb"][:2] = (1.0, 2.0)
    job["det_seqs_v"][0:5, 0] = 1.0
    job["det_seqs_sr"][0:5, 0] = (2.0, 2.0, 2.0, 1.0, 25.0)
    job["det_seqs_v"][2:7, 1] = 2.0
    job["det_seqs_sr"][2:7, 1] = (1.0, 3.0, 3.0, 7.0, 25.0)
    job["verb_list"][4, 0] = 1.0
    job["verb_list"][6, 0] = 2.0
    jobs0.append(job)
    # one role carried by 12 slots (> sinkhorn_len): truncated ranks
    job = empty_job(rng)
    job["control_verb"][0] = 5.0
    job["det_seqs_v"][:, 0:2] = 5.0
    job["det_seqs_sr"][:, 0] = 2.0
    job["det_seqs_sr"][0:2, 1] = 2.0
    job["det_seqs_sr"][2:, 1] = 6.0
    jobs0.append(job)
    jobs0 += [fuzz_job(rng) for _ in range(4)]
    jobs1 = [empty_job(rng) for _ in range(3)]
    jobs1[0]["control_verb"][0] = 4.0     # a verb that no slot carries
    out = []
    for jobs in (jobs0, jobs1):
        fields = {f: np.stack([j[f] for j in jobs]) for f in JOB_FIELDS}
        fields["detections"] = rng.rand(len(jobs), PL_NDET, D).astype(
            np.float32)
        out.append(fields)
    return out


def jobs_from(fields, caption_job):
    """A batch's dict of stacked arrays -> list of `caption_job`s."""
    return [caption_job(**{f: fields[f][p] for f in JOB_FIELDS})
            for p in range(len(fields["control_verb"]))]


def jax_pipeline(params, fast=None):
    import jax
    import jax.numpy as jnp
    from vsrcic_tpu.pipelines import EvalPipeline
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return EvalPipeline(jax_captioner(params["captioner"], fast),
                        to_j(params["ssp"]), ssp_cfg("jax"),
                        to_j(params["sinkhorn"]), sink_cfg("jax"),
                        eos_word=EOS, beam_size=PL_BEAM)


def torch_pipeline(params, fast=None, device="cpu", **kw):
    from vsrcic_tpu_torch.pipelines import EvalPipeline
    from vsrcic_tpu_torch.utils.params import params_from_jax
    return EvalPipeline(torch_captioner(params["captioner"], fast, device),
                        params_from_jax(params["ssp"], device),
                        ssp_cfg("torch"),
                        params_from_jax(params["sinkhorn"], device),
                        sink_cfg("torch"), eos_word=EOS, beam_size=PL_BEAM,
                        device=device, **kw)


def jax_plan(pipe, jobs):
    """JAX plan_dispatch + plan_finish, keeping the device results."""
    import jax
    pend = pipe.plan_dispatch(jobs)
    P_soft, preds = jax.device_get((pend.P_soft_dev, pend.preds_dev))
    rank_idx, rank_valid, verb_lists = pipe.plan_finish(pend)
    n = pipe.sinkhorn_len
    return dict(
        P_soft=np.zeros((0, n, n), np.float32) if P_soft is None
        else np.asarray(P_soft),
        preds=np.zeros((0, pipe.ssp_cfg.max_len), np.int32) if preds is None
        else np.asarray(preds),
        rank_idx=rank_idx, rank_valid=rank_valid, verb_lists=verb_lists)


def torch_plan(pipe, jobs):
    """The port's plan_dispatch + plan_finish, keeping the plan's device
    results (read back into host buffers)."""
    pend = pipe.plan_dispatch(jobs)
    rank_idx, rank_valid, verb_lists = pipe.plan_finish(pend)
    n = pipe.sinkhorn_len

    def host(t, shape, dtype):
        return np.zeros(shape, dtype) if t is None else t.cpu().numpy()
    return dict(P_soft=host(pend.P_soft, (0, n, n), np.float32),
                preds=host(pend.preds, (0, pipe.ssp_cfg.max_len), np.int32),
                rank_idx=rank_idx, rank_valid=rank_valid,
                verb_lists=verb_lists)


def assert_plans_match(got, want, tag=""):
    """Tokens, ranks and verb lists identical; P_soft within 1e-6."""
    for f in PLAN_FIELDS:
        if f == "P_soft":
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6,
                                       err_msg=tag + f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=tag + f)


def pipeline_golden_arrays(paths=("strict", "fast_bf16")):
    """The pipeline fixture's contents, computed by the JAX package, with
    the plans and words of the captioner `paths` (strict: the dense f32
    beam; fast_bf16: fused attention + vocab top-k, bf16 tables)."""
    from vsrcic_tpu.pipelines import CaptionJob
    from vsrcic_tpu_torch.utils.params import flatten
    params = pipeline_params()
    batches = pipeline_batch_fields()
    out = {"param/" + k: v for k, v in flatten(params).items()}
    out.update(verb_table=np.array(json.dumps(VERB_TABLE, sort_keys=True)),
               eos_word=np.int64(EOS), beam_size=np.int64(PL_BEAM),
               config=np.array(json.dumps(dict(
                   captioner=dict(seq_len=T, vocab_size=V, bos_idx=BOS,
                                  det_feat_size=D, input_encoding_size=E,
                                  rnn_size=R, att_size=A),
                   ssp=SSP_KW, sinkhorn=SINK_KW), sort_keys=True)))
    for b, fields in enumerate(batches):
        for f, x in fields.items():
            out["b%d/%s" % (b, f)] = x
    for name in paths:
        pipe = jax_pipeline(params, None if name == "strict" else "bf16")
        for b, fields in enumerate(batches):
            jobs = jobs_from(fields, CaptionJob)
            for f, x in jax_plan(pipe, jobs).items():
                out["%s/b%d/%s" % (name, b, f)] = x
            out["%s/b%d/words" % (name, b)] = np.asarray(
                pipe.run_batch(fields["detections"], jobs)).astype(np.int64)
    return out


def load_golden_pipeline():
    """(params, configs, batches, golden) from the committed fixture."""
    from vsrcic_tpu_torch.utils.params import unflatten
    with np.load(GOLDEN_PIPELINE) as z:
        g = {k: z[k] for k in z.files}
    params = unflatten({k[len("param/"):]: v for k, v in g.items()
                        if k.startswith("param/")})
    batches = []
    while "b%d/control_verb" % len(batches) in g:
        pre = "b%d/" % len(batches)
        batches.append({k[len(pre):]: v for k, v in g.items()
                        if k.startswith(pre)})
    return params, json.loads(str(g["config"])), batches, g


# ---------------------------------------------------------------------------
# the trainers' world (tests/test_trainers.py's sizes)
# ---------------------------------------------------------------------------

GOLDEN_TRAIN = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                            "golden_train.npz")
TR_KW = dict(seq_len=8, vocab_size=30, bos_idx=BOS, det_feat_size=16,
             input_encoding_size=12, rnn_size=10, att_size=8)
TR_B, TR_M, TR_N, TR_L = 4, 3, 6, 5
TR_LR = 1e-3
# 26 one-letter words + 4 specials: a text field whose vocabulary has
# TR_KW["vocab_size"] entries
WORDS = [chr(ord("a") + i) for i in range(26)]


def train_cfg(pkg):
    if pkg == "jax":
        from vsrcic_tpu.models.captioner import CaptionerConfig
    else:
        from vsrcic_tpu_torch.models.captioner import CaptionerConfig
    return CaptionerConfig(**TR_KW)


def train_params(seed=0):
    """The trainers' parameters, made by the JAX package (its init under
    jit: one compile instead of the eager init's per-op dispatch). The
    tests read them from the committed fixture (`load_golden_train`)."""
    import jax
    from vsrcic_tpu.models.captioner import init_captioner_params
    return to_numpy_tree(jax.jit(init_captioner_params, static_argnums=1)(
        jax.random.PRNGKey(seed), train_cfg("jax")))


def xe_batch(seed=0):
    """(detections, captions, compact ids, gate targets): the last detection
    of every item is empty, ids hold -1 padding, gate targets hold -1."""
    rng = np.random.RandomState(seed)
    v, t, d = TR_KW["vocab_size"], TR_KW["seq_len"], TR_KW["det_feat_size"]
    detections = rng.rand(TR_B, TR_N, d).astype(np.float32)
    detections[:, -1] = 0.0
    captions = rng.randint(0, v, size=(TR_B, t)).astype(np.int64)
    ids = rng.randint(-1, TR_N, size=(TR_B, t, TR_M)).astype(np.int64)
    gates = rng.randint(0, 2, size=(TR_B, t)).astype(np.int64)
    gates[:, -2:] = -1
    gates[0, 1] = -1
    return detections, captions, ids, gates


def dense_groups(detections, ids):
    """The (..., M, D) groups that compact ids stand for (a loop oracle)."""
    out = np.zeros(ids.shape + (detections.shape[-1],), np.float32)
    for idx in np.ndindex(ids.shape):
        if ids[idx] >= 0:
            out[idx] = detections[idx[0], ids[idx]]
    return out


def scst_batch(seed=1):
    """(detections, dense groups (B, L, M, D) with empty regions, GT
    captions)."""
    rng = np.random.RandomState(seed)
    d = TR_KW["det_feat_size"]
    detections = rng.rand(TR_B, TR_N, d).astype(np.float32)
    ids = rng.randint(-1, TR_N, size=(TR_B, TR_L, TR_M))
    gts = [" ".join(rng.choice(WORDS, size=rng.randint(3, 7)))
           for _ in range(TR_B)]
    return detections, dense_groups(detections, ids), gts


def text_world(pkg):
    """(TextField over WORDS, Cider with the GT captions' df) in `pkg`."""
    if pkg == "jax":
        from vsrcic_tpu.metrics import Cider
        from vsrcic_tpu.text import TextField, ptb_tokenize
    else:
        from vsrcic_tpu_torch.metrics import Cider
        from vsrcic_tpu_torch.text import TextField, ptb_tokenize
    tf = TextField(fix_length=TR_KW["seq_len"])
    tf.build_vocab([" ".join(WORDS)], min_freq=1)
    gts = scst_batch()[2]
    return tf, Cider(gts=ptb_tokenize({i: [c] for i, c in enumerate(gts)}))


# the trainers' tolerances: losses within rtol 1e-5, gradients within
# rtol 1e-4 / atol 1e-6 of jax.value_and_grad
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def grad_tol(want, scaled=False):
    """GRAD_TOL; with scaled=True an atol of 1e-5 times the leaf's largest
    magnitude where that exceeds 1. The 2352-d Sinkhorn net's f32
    gradients carry round-off of up to ~2e-6 of a leaf's largest entry in
    both packages, each as far from a float64 evaluation
    (tests/test_torch_sinkhorn_train.py::test_full_width_grads_f32_noise,
    which holds each to 5e-6 of it), so an element small beside its leaf's
    largest can miss rtol 1e-4 / atol 1e-6 in either package."""
    if not scaled:
        return GRAD_TOL
    return dict(GRAD_TOL, atol=1e-5 * max(
        1.0, float(np.abs(want).max(initial=0.0))))


def assert_grads_match(got, want, exact_zeros=True, scaled=False):
    """Every leaf within GRAD_TOL (see grad_tol for `scaled`), and with
    exact_zeros, JAX's exact zeros exact."""
    got, want = flat_grads(got), flat_grads(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **grad_tol(want[k], scaled))
        if exact_zeros:
            np.testing.assert_array_equal(got[k][want[k] == 0], 0.0,
                                          err_msg=k)


def flat_grads(grads):
    """A gradient tree (JAX or torch) as {"a.b.weight": numpy}."""
    from vsrcic_tpu_torch.utils.params import flatten
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in flatten(grads).items()}


def scst_trajectory(seed=2):
    """Given words, gates and advantages for the SCST grad step."""
    rng = np.random.RandomState(seed)
    t = TR_KW["seq_len"]
    return (rng.randint(0, TR_KW["vocab_size"], size=(TR_B, t)),
            rng.randint(0, 2, size=(TR_B, t)),
            rng.randn(TR_B).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_train_fns():
    """Jitted JAX programs shared by the trainers' tests and the fixture
    writer (one compile per process): value_and_grad of xe_loss_fn (static
    cfg, lean) and of scst_loss_fn (static cfg, remat), and the strict
    greedy decode of the trainers' config."""
    import jax
    from vsrcic_tpu.decode.loops import greedy_decode
    from vsrcic_tpu.models.captioner import precompute_statics
    from vsrcic_tpu.train.captioner import scst_loss_fn, xe_loss_fn
    cfg = train_cfg("jax")

    def greedy(params, detections, groups):
        return greedy_decode(params, cfg, precompute_statics(
            params, cfg, detections, groups))
    return dict(
        xe=jax.jit(jax.value_and_grad(xe_loss_fn, has_aux=True),
                   static_argnums=(1,), static_argnames=("lean",)),
        scst=jax.jit(jax.value_and_grad(scst_loss_fn), static_argnums=(1,),
                     static_argnames=("remat",)),
        greedy=jax.jit(greedy))


def train_golden_arrays():
    """The trainers' fixture, computed by the JAX package: the lean compact
    XE loss and gradients at three Adam steps (lr TR_LR), the SCST loss and
    gradients of a given trajectory (remat), and strict greedy words and
    gates."""
    import jax
    import jax.numpy as jnp
    from vsrcic_tpu.train import common
    from vsrcic_tpu_torch.utils.params import flatten
    fns = jax_train_fns()
    cfg = train_cfg("jax")
    params_np = train_params()
    params = jax.tree.map(jnp.asarray, params_np)
    det, caps, ids, gates = xe_batch()
    out = {"param/" + k: v for k, v in flatten(params_np).items()}
    out.update(config=np.array(json.dumps(TR_KW, sort_keys=True)),
               lr=np.float32(TR_LR), **{"xe/" + k: v for k, v in zip(
                   ("detections", "captions", "ids", "gates"),
                   (det, caps, ids, gates))})
    jargs = (jnp.asarray(det), jnp.asarray(caps, jnp.int32),
             jnp.asarray(ids, jnp.int32), jnp.asarray(gates, jnp.int32))
    tx = common.adam(TR_LR)
    state = common.init_train_state(params, tx)
    apply = jax.jit(lambda st, g: common.apply_grads(tx, st, g))
    losses = []
    for step in range(3):
        (loss, _), grads = fns["xe"](state.params, cfg, *jargs)
        if step == 0:
            out.update({"xe/grad/" + k: v
                        for k, v in flat_grads(grads).items()})
        losses.append(float(loss))
        state = apply(state, grads)
    out["xe/losses"] = np.array(losses, np.float32)
    s_det, s_grp, _ = scst_batch()
    words, s_gates, adv = scst_trajectory()
    out.update({"scst/detections": s_det, "scst/groups": s_grp,
                "scst/words": words, "scst/gates": s_gates,
                "scst/advantage": adv})
    loss, grads = fns["scst"](
        params, cfg, jnp.asarray(s_det), jnp.asarray(s_grp),
        jnp.asarray(words, jnp.int32), jnp.asarray(s_gates, jnp.int32),
        jnp.asarray(adv), remat=True)
    out["scst/loss"] = np.float32(loss)
    out.update({"scst/grad/" + k: v for k, v in flat_grads(grads).items()})
    g_words, g_gates = fns["greedy"](params, jnp.asarray(s_det),
                                     jnp.asarray(s_grp))
    out["greedy/words"] = np.asarray(g_words).astype(np.int64)
    out["greedy/gates"] = np.asarray(g_gates).astype(np.int64)
    return out


def load_golden_train():
    """(params, {key: array}) from the committed trainers' fixture."""
    from vsrcic_tpu_torch.utils.params import unflatten
    with np.load(GOLDEN_TRAIN) as z:
        g = {k: z[k] for k in z.files}
    return unflatten({k[len("param/"):]: v for k, v in g.items()
                      if k.startswith("param/")}), g


def full_width_xe_losses(positive, batch=6, steps=5):
    """Five XE trainer losses of JAX and of the port, on the CPU, at the
    CLI's widths (CaptionerConfig()) and chip_smoke.py phase 10's batch
    layout at a small batch, with standard normal detection features or
    their absolute values (positive=True). Weights from the port's init
    (seed 0), lr 5e-4. Returns (jax losses, port losses)."""
    import jax
    import jax.numpy as jnp
    import torch
    from vsrcic_tpu.models.captioner import CaptionerConfig as JaxConfig
    from vsrcic_tpu.train.captioner import CaptionerXETrainer as JaxXE
    from vsrcic_tpu_torch.models.captioner import (CaptionerConfig,
                                                   init_captioner_params)
    from vsrcic_tpu_torch.train.captioner import CaptionerXETrainer
    from vsrcic_tpu_torch.utils.params import params_to_numpy
    b, n, t, m, v, d = batch, 100, 20, 20, 10000, 2048
    rng = np.random.RandomState(0)
    n_real = n - rng.randint(0, 61, b)
    det = rng.randn(b, n, d).astype(np.float32)
    det = np.abs(det) if positive else det
    det *= (np.arange(n)[None] < n_real[:, None])[..., None]
    length = rng.randint(5, 19, b)
    pos = np.arange(t)[None]
    caps = np.where(pos == 0, 2, np.where(
        pos <= length[:, None], rng.randint(4, v, (b, t)),
        np.where(pos == length[:, None] + 1, 3, 1)))
    regions = rng.randint(1, m + 1, (b, t))
    ids = (rng.rand(b, t, m) * n_real[:, None, None]).astype(np.int64)
    ids = np.where(np.arange(m) < regions[..., None], ids, -1)
    gates = np.where(pos <= length[:, None] + 1,
                     (rng.rand(b, t) < 0.3).astype(np.int64), -1)
    params = params_to_numpy(init_captioner_params(
        torch.Generator().manual_seed(0), CaptionerConfig()))
    batch_ = (det, caps, ids, gates)
    jt = JaxXE(JaxConfig(), jax.tree.map(jnp.asarray, params), lr=5e-4)
    tt = CaptionerXETrainer(CaptionerConfig(), params, lr=5e-4,
                            device="cpu")
    jbatch = (det, caps, ids.astype(np.int32), gates)
    return ([jt.step(*jbatch)[0] for _ in range(steps)],
            [tt.step(*batch_)[0] for _ in range(steps)])


# ---------------------------------------------------------------------------
# the planner trainers' world
# ---------------------------------------------------------------------------

def ssp_train_batch(seed, n, l=10):
    """(verbs (n, 1), det_sr (n, l), gt_sr (n, l)) as the grid batcher
    builds them (floats): raw verb codes (Flickr's 10000 * occurrence
    kept), k distinct roles per group, the GT order a permutation of them;
    one group's GT grid lacks the verb (all zeros), one has a single role,
    one all ten."""
    rng = np.random.RandomState(seed)
    verbs = (rng.randint(1, 2662, (n, 1))
             + 10000 * rng.randint(0, 3, (n, 1))).astype(np.float64)
    det_sr = np.zeros((n, l))
    gt_sr = np.zeros((n, l))
    for i in range(n):
        k = (1, l)[i] if i < 2 else rng.randint(1, l + 1)
        roles = rng.choice(np.arange(1, 26), k, replace=False)
        det_sr[i, :k] = roles
        gt_sr[i, :k] = rng.permutation(roles)
    gt_sr[n - 1] = 0.0
    return verbs, det_sr, gt_sr


def ssp_beam_inputs(seed=6, b=7, l=10):
    """(verb, det_sr) with the selection's edge rows first: an empty
    multiset, a single role, all-duplicate roles."""
    rng = np.random.RandomState(seed)
    det_sr = rng.randint(1, 26, (b, l)).astype(np.float64)
    det_sr[0, :] = 0
    det_sr[1, 1:] = 0
    det_sr[2, :] = det_sr[2, 0]
    det_sr[3, 5:] = 0
    verb = rng.randint(1, 2662, (b, 1)).astype(np.float64)
    return verb, det_sr


def assignment_profits(case, seed=0):
    """(N, N) f32 profits for greedy_assign_device: uniform noise;
    tied ones (small integers, a constant matrix, the identity); soft
    permutations from JAX's Sinkhorn normalization."""
    rng = np.random.RandomState(seed)
    if case == "random":
        return [rng.rand(n, n).astype(np.float32) for n in (1, 4, 10)]
    if case == "ties":
        return [rng.randint(0, 3, (n, n)).astype(np.float32)
                for n in (3, 6, 10)] + [np.full((5, 5), 0.5, np.float32),
                                        np.eye(4, dtype=np.float32)]
    from vsrcic_tpu.models.sinkhorn import sinkhorn_normalize
    x = np.tanh(rng.randn(4, 10, 10)).astype(np.float32)
    return list(np.asarray(sinkhorn_normalize(x, 20, 0.1)))


GOLDEN_PLANNERS = os.path.join(REPO, "vsrcic_tpu_torch", "testdata",
                               "golden_planners.npz")
# S-SSP hidden 64, 2 + 2 layers, COCO's 2662 verbs; the 2352-d Sinkhorn
GP_SSP_KW = dict(hidden_size=64, embed_size=64, encoder_layers=2,
                 decoder_layers=2)
GP_SSP_SEED, GP_SINK_SEED = 11, 12
GP_GROUPS, GP_PAIRS, GP_IMAGES, GP_BEAM = 24, 6, 4, 3
GP_GRAD_SAMPLE = 2048


def grad_sample(x, cap=GP_GRAD_SAMPLE):
    """Every k-th entry of a gradient leaf, k = max(1, size // cap), as the
    planners' fixture stores it (chip_smoke.py phase 11 takes the same)."""
    flat = np.asarray(x).reshape(-1)
    return flat[::max(1, flat.size // cap)]


def golden_planner_params():
    """{ssp, sinkhorn}: the fixture's weights as numpy trees, drawn from
    numpy seeds over the port's parameter trees."""
    import torch
    from vsrcic_tpu_torch.models.s_ssp import SSPConfig, init_ssp_params
    from vsrcic_tpu_torch.models.sinkhorn import (SinkhornConfig,
                                                  init_sinkhorn_params)
    from vsrcic_tpu_torch.utils.params import seeded_params
    gen = torch.Generator().manual_seed(0)
    return {"ssp": seeded_params(init_ssp_params(gen, SSPConfig(
                **GP_SSP_KW)), GP_SSP_SEED),
            "sinkhorn": seeded_params(init_sinkhorn_params(
                gen, SinkhornConfig()), GP_SINK_SEED)}


def sinkhorn_train_batch(seed, n_pairs, width=2352, n=10):
    """(inputs (N, n, width), tr_locs, gt_locs) as sinkhorn_pairs_from_grids
    builds them: 2-5 slots per pair, the rest zero rows and 10.0 locations;
    tr_locs the slots, gt_locs the argsort of their idx_list ranks. The
    features are multiples of 1/16 below 1 (exact in float16, so the
    fixture stores them in half the bytes)."""
    rng = np.random.RandomState(seed)
    inputs = np.zeros((n_pairs, n, width), np.float32)
    tr_locs = np.full((n_pairs, n), 10.0, np.float32)
    gt_locs = np.full((n_pairs, n), 10.0, np.float32)
    for p in range(n_pairs):
        c = rng.randint(2, 6)
        tr_locs[p, :c] = np.sort(rng.choice(n, c, replace=False))
        ranks = np.full(n, 10.0, np.float32)
        ranks[:c] = rng.permutation(c)
        gt_locs[p, :c] = np.argsort(ranks)[:c]
        inputs[p, :c] = np.floor(rng.rand(c, width) * 16) / 16
    return inputs, tr_locs, gt_locs


def jax_sinkhorn_loss(params, cfg, inputs, tr_locs, gt_locs, denom):
    """The loss inside vsrcic_tpu.train.planners.SinkhornTrainer's step
    (planners.py:148-152), which the JAX package does not expose."""
    import jax.numpy as jnp
    from vsrcic_tpu.models.sinkhorn import sinkhorn_net_apply
    P = sinkhorn_net_apply(params, cfg, inputs)
    resort = jnp.einsum("nl,nlm->nm", tr_locs, P)
    return jnp.sum(jnp.mean((resort - gt_locs) ** 2, -1)) / denom


@functools.lru_cache(maxsize=None)
def jax_planner_fns():
    """Jitted JAX programs of the planner tests and the fixture writer:
    value_and_grad of ssp_forward_loss (static cfg) and of the Sinkhorn
    trainer's loss (static cfg)."""
    import jax
    from vsrcic_tpu.models.s_ssp import ssp_forward_loss
    return dict(
        ssp=jax.jit(jax.value_and_grad(ssp_forward_loss), static_argnums=1),
        sink=jax.jit(jax.value_and_grad(jax_sinkhorn_loss),
                     static_argnums=1))


def planners_golden_arrays():
    """The planner trainers' fixture, computed by the JAX package: the
    S-SSP loss and gradients (dropout off), the Sinkhorn trainer's loss and
    gradients under both normalisations, S-SSP beam sequences and scores,
    and greedy assignments of the Sinkhorn outputs and of tied profits."""
    import jax
    import jax.numpy as jnp
    from vsrcic_tpu.models.s_ssp import SSPConfig, ssp_beam_search
    from vsrcic_tpu.models.sinkhorn import (SinkhornConfig,
                                            sinkhorn_net_apply)
    from vsrcic_tpu.ops.assignment import greedy_assign_device
    from vsrcic_tpu_torch.utils.params import flatten
    fns = jax_planner_fns()
    params = jax.tree.map(jnp.asarray, golden_planner_params())
    ssp_cfg, sink_cfg = SSPConfig(**GP_SSP_KW), SinkhornConfig()
    out = {"config": np.array(json.dumps(dict(
        ssp=GP_SSP_KW, ssp_seed=GP_SSP_SEED, sinkhorn_seed=GP_SINK_SEED,
        n_images=GP_IMAGES, beam_size=GP_BEAM,
        grad_sample=GP_GRAD_SAMPLE), sort_keys=True))}
    verbs, det_sr, gt_sr = ssp_train_batch(7, GP_GROUPS)
    loss, grads = fns["ssp"](params["ssp"], ssp_cfg, jnp.asarray(verbs),
                             jnp.asarray(det_sr), jnp.asarray(gt_sr))
    out.update({"ssp/verbs": verbs, "ssp/det_sr": det_sr,
                "ssp/gt_sr": gt_sr, "ssp/loss": np.float32(loss)})
    out.update({"ssp/grad/" + k: grad_sample(v)
                for k, v in flatten(grads).items()})
    b_verb, b_det = ssp_beam_inputs()
    seqs, scores = jax.jit(lambda v, d: ssp_beam_search(
        params["ssp"], ssp_cfg, v, d, beam_size=GP_BEAM))(
            jnp.asarray(b_verb), jnp.asarray(b_det))
    out.update({"beam/verb": b_verb, "beam/det_sr": b_det,
                "beam/seqs": np.asarray(seqs),
                "beam/scores": np.asarray(scores)})
    inputs, tr_locs, gt_locs = sinkhorn_train_batch(8, GP_PAIRS)
    out.update({"sink/inputs": inputs.astype(np.float16),
                "sink/tr_locs": tr_locs, "sink/gt_locs": gt_locs})
    for norm, denom in (("images", GP_IMAGES), ("pairs", GP_PAIRS)):
        loss, grads = fns["sink"](params["sinkhorn"], sink_cfg,
                                  jnp.asarray(inputs), jnp.asarray(tr_locs),
                                  jnp.asarray(gt_locs),
                                  jnp.asarray(np.float32(denom)))
        out["sink/%s/loss" % norm] = np.float32(loss)
        out.update({"sink/%s/grad/%s" % (norm, k): grad_sample(v)
                    for k, v in flatten(grads).items()})
    profits = list(np.asarray(jax.jit(lambda s: sinkhorn_net_apply(
        params["sinkhorn"], sink_cfg, s))(jnp.asarray(inputs))))
    profits += [assignment_profits("ties")[2],
                np.full((10, 10), 0.5, np.float32)]
    out["assign/profits"] = np.stack(profits)
    out["assign/cols"] = np.stack([np.asarray(jax.jit(greedy_assign_device)(
        jnp.asarray(p))) for p in profits])
    return out


def load_golden_planners():
    """{key: array} from the committed planner trainers' fixture."""
    with np.load(GOLDEN_PLANNERS) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the eval CLI's world
# ---------------------------------------------------------------------------

# 8 test images in 3 batches of at most 3, a 32-d feature store, the
# tiny captioner of tests/test_cli_lifecycle.py
EVAL_CLI_ARGV = ["--synthetic", "--synthetic_images", "64", "--batch_size",
                 "3", "--seed", "7", "--feat_dim", "32", "--rnn_size", "16",
                 "--att_size", "8", "--input_encoding_size", "16",
                 "--limit", "8"]
EVAL_CLI_SSP = ["--ssp_hidden_size", "16", "--ssp_embed_size", "16",
                "--ssp_layers", "1"]
EVAL_CLI_FAST = ["--fused", "--vocab_topk", "--bf16_tables"]
EVAL_CLI_MODES = {"plain": [], "det": ["--det"], "gt": ["--gt"],
                  "det_gt": ["--det", "--gt"]}


def eval_cli_trees(dataset):
    """The tiny checkpoints of `dataset`'s world (eval_checkpoints' trees),
    with every f32 weight rounded to f16 so that the fixture can hold it
    as f16 exactly."""
    from vsrcic_tpu_torch.tools.eval_checkpoints import checkpoint_trees
    trees = checkpoint_trees(["--dataset", dataset] + EVAL_CLI_ARGV
                             + EVAL_CLI_SSP)

    def round16(t):
        return {k: (round16(v) if isinstance(v, dict)
                    else v.astype(np.float16).astype(np.float32))
                for k, v in t.items()}

    for tree in trees.values():
        tree["params"] = round16(tree["params"])
    return trees


def run_eval_cli(main, argv, dump):
    """main(argv + --dump_preds dump) with its standard output captured:
    {"cider", "n", "metrics", "dump"} (eval_checkpoints.run_captured)."""
    from vsrcic_tpu_torch.tools.eval_checkpoints import run_captured
    return run_captured(main, argv, dump)[0]


def jax_pallas_interpret_captioner():
    """A stand-in for `vsrcic_tpu.models.api.ControllableCaptioner` that
    turns the JAX eval CLI's CPU choice for --vocab_topk (its "xla"
    candidate path, which reads an f32 out_fc table under --bf16_tables)
    into the Pallas kernels in interpret mode, as the JAX package's tests
    run them on the CPU: the function the port's kernels compute."""
    from vsrcic_tpu.models import api

    class Interpret(api.ControllableCaptioner):
        def __init__(self, *a, use_vocab_topk=False, **kw):
            if use_vocab_topk == "xla":
                use_vocab_topk, kw["pallas_interpret"] = True, True
            super().__init__(*a, use_vocab_topk=use_vocab_topk, **kw)

    return Interpret


def eval_cli_golden_arrays():
    """The eval CLI's golden fixture, computed by the JAX CLI from the tiny
    checkpoints: for COCO and Flickr, strict (no flag) and fast
    (EVAL_CLI_FAST, Pallas kernels in interpret mode) runs."""
    import tempfile
    from vsrcic_tpu.cli import eval as jax_eval
    from vsrcic_tpu.core.checkpoint import _flatten, _save_npz
    from vsrcic_tpu.models import api
    from vsrcic_tpu_torch.tools.eval_checkpoints import (NAMES,
                                                         golden_ckpt_prefix)
    out = {"argv": np.array(json.dumps(EVAL_CLI_ARGV)),
           "fast_flags": np.array(json.dumps(EVAL_CLI_FAST))}
    orig = api.ControllableCaptioner
    with tempfile.TemporaryDirectory() as tmp:
        for ds in ("coco", "flickr"):
            trees = eval_cli_trees(ds)
            flags = ["--dataset", ds] + EVAL_CLI_ARGV + ["--platform", "cpu"]
            for name in NAMES:
                path = os.path.join(tmp, "%s_%s.npz" % (ds, name))
                _save_npz(path, trees[name])
                flags += ["--%s_ckpt" % name, path]
                for k, v in _flatten(trees[name]).items():
                    key = golden_ckpt_prefix(ds, name) + k
                    v = v.astype(np.float16) if k.startswith("params/") else v
                    # the Sinkhorn net is the same for both worlds: held once
                    assert key not in out or np.array_equal(out[key], v), key
                    out[key] = v
            for mode, extra in (("strict", []), ("fast", EVAL_CLI_FAST)):
                api.ControllableCaptioner = (
                    jax_pallas_interpret_captioner() if extra else orig)
                try:
                    res = run_eval_cli(jax_eval.main, flags + extra,
                                       os.path.join(tmp, "dump.jsonl"))
                finally:
                    api.ControllableCaptioner = orig
                pre = "%s/%s/" % (ds, mode)
                out[pre + "dump"] = np.array(res["dump"])
                out[pre + "metrics"] = np.array("\n".join(res["metrics"]))
                out[pre + "cider"] = np.float64(res["cider"])
                out[pre + "n"] = np.int64(res["n"])
    return out


def golden_eval_cli_result(golden, dataset, mode):
    pre = "%s/%s/" % (dataset, mode)
    return {"cider": float(golden[pre + "cider"]), "n": int(golden[pre + "n"]),
            "metrics": str(golden[pre + "metrics"]).split("\n"),
            "dump": str(golden[pre + "dump"])}


# ---------------------------------------------------------------------------
# the train CLIs' world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_orbax():
    """Hide orbax from imports for the block: the JAX package's
    `save_checkpoint` then writes npz, as it does where orbax is absent,
    and the port reads its checkpoints."""
    import builtins
    real_import = builtins.__import__

    def hidden(name, *a, **kw):
        if name.startswith("orbax"):
            raise ImportError("orbax hidden")
        return real_import(name, *a, **kw)

    builtins.__import__ = hidden
    try:
        yield
    finally:
        builtins.__import__ = real_import


def f16_exact(tree):
    """Every f32 leaf of a nested dict rounded to f16 (and kept f32)."""
    return {k: (f16_exact(v) if isinstance(v, dict)
                else np.asarray(v).astype(np.float16).astype(np.float32))
            for k, v in tree.items()}


def train_cli_inits():
    """{run: flat initial checkpoint} of the train CLIs' fixture: the JAX
    package's initialisers under PRNGKey(7) at the fixture's widths,
    rounded to f16, with the cfg blobs the JAX CLIs write."""
    import jax
    from vsrcic_tpu.cli.common import base_parser, build_world
    from vsrcic_tpu.core.checkpoint import _flatten
    from vsrcic_tpu.models.captioner import (CaptionerConfig,
                                             init_captioner_params)
    from vsrcic_tpu.models.sinkhorn import (SinkhornConfig,
                                            init_sinkhorn_params)
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    opt, _ = base_parser().parse_known_args(["--dataset", "coco"] + g.ARGV)
    tf = build_world(opt).text_field
    cap = CaptionerConfig(seq_len=20, vocab_size=len(tf.vocab),
                          bos_idx=tf.bos_idx, det_feat_size=opt.feat_dim,
                          input_encoding_size=opt.input_encoding_size,
                          rnn_size=opt.rnn_size, att_size=opt.att_size)
    sink = SinkhornConfig(n=10, n_iters=20, tau=0.1, vis_dim=opt.feat_dim)
    key = jax.random.PRNGKey(opt.seed)
    xe = {"params": f16_exact(to_numpy_tree(init_captioner_params(key, cap))),
          "step": np.asarray(0),
          "cfg": {f: np.asarray(getattr(cap, f)) for f in (
              "seq_len", "vocab_size", "bos_idx", "det_feat_size",
              "input_encoding_size", "rnn_size", "att_size",
              "h2_first_lstm", "img_second_lstm")}}
    sh = {"params": f16_exact(to_numpy_tree(init_sinkhorn_params(key, sink))),
          "step": np.asarray(0), "epoch": np.asarray(-1),
          "cfg": {f: np.asarray(getattr(sink, f)) for f in (
              "n", "n_iters", "tau", "txt_dim", "vis_dim", "pos_dim")}}
    return {"xe": _flatten(xe), "sinkhorn_coco": _flatten(sh),
            "sinkhorn_flickr": _flatten(sh)}


def jax_train_cli_modules():
    from vsrcic_tpu.cli import train, train_region_sort, train_sinkhorn
    return {"train": train, "train_sinkhorn": train_sinkhorn,
            "train_region_sort": train_region_sort}


def run_jax_train_cli(run, flat, root):
    """The JAX CLI's run `run` of the fixture from the initial checkpoint
    `flat` under `root` (orbax hidden): (run_captured's result, the saved
    weights as the fixture holds them)."""
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    g.write_init(root, run, flat)
    with no_orbax():
        res = g.run_captured(jax_train_cli_modules()[g.RUNS[run][0]].main,
                             g.argv_for(run, root) + ["--platform", "cpu"])
    return res, g.saved_params(root, run)


def train_cli_golden_arrays():
    """The train CLIs' golden fixture, from the JAX CLIs (see
    vsrcic_tpu_torch/tools/train_cli_golden.py)."""
    import tempfile
    from vsrcic_tpu_torch.tools import train_cli_golden as g
    out = {"argv": np.array(json.dumps(g.ARGV))}
    with tempfile.TemporaryDirectory() as tmp:
        for run, flat in train_cli_inits().items():
            for k, v in flat.items():
                key = g.init_prefix(run) + k
                v = v.astype(np.float16) if k.startswith("params/") else v
                assert key not in out or np.array_equal(out[key], v), key
                out[key] = v
            res, saved = run_jax_train_cli(run, flat,
                                           os.path.join(tmp, run))
            out[run + "/losses"] = np.asarray(res["losses"], np.float64)
            out[run + "/lines"] = np.array(json.dumps(res["lines"]))
            for k, v in saved.items():
                out[run + "/saved/" + k] = v
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    if "--xe-full-width" in sys.argv[1:]:
        for positive in (True, False):
            want, got = full_width_xe_losses(positive)
            print("features %s: JAX %s, port %s" % (
                "|normal|" if positive else "normal",
                ["%.4f" % x for x in want], ["%.4f" % x for x in got]))
        sys.exit(0)
    if "--train-cli" in sys.argv[1:]:
        from vsrcic_tpu_torch.tools.train_cli_golden import GOLDEN as G
        np.savez_compressed(G, **train_cli_golden_arrays())
        print("wrote", G, os.path.getsize(G), "bytes")
        sys.exit(0)
    if "--eval-cli" in sys.argv[1:]:
        from vsrcic_tpu_torch.tools.eval_checkpoints import GOLDEN as G
        np.savez_compressed(G, **eval_cli_golden_arrays())
        print("wrote", G, os.path.getsize(G), "bytes")
        sys.exit(0)
    if "--bf16" in sys.argv[1:]:
        from vsrcic_tpu_torch.tools.golden_bf16 import GOLDEN as G
        np.savez_compressed(G, **golden_bf16_arrays())
        print("wrote", G, os.path.getsize(G), "bytes")
        sys.exit(0)
    if "--planners" in sys.argv[1:]:
        np.savez_compressed(GOLDEN_PLANNERS, **planners_golden_arrays())
        print("wrote", GOLDEN_PLANNERS,
              os.path.getsize(GOLDEN_PLANNERS), "bytes")
        sys.exit(0)
    np.savez_compressed(GOLDEN, **golden_arrays())
    print("wrote", GOLDEN)
    np.savez_compressed(GOLDEN_PIPELINE, **pipeline_golden_arrays())
    print("wrote", GOLDEN_PIPELINE)
    np.savez_compressed(GOLDEN_TRAIN, **train_golden_arrays())
    print("wrote", GOLDEN_TRAIN)
