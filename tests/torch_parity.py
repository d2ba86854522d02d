"""Shared fixtures of the port's parity tests (tests/test_torch_*.py), and
the writer of the port's golden fixtures.

The beam inputs are those of tests/test_vocab_topk.py: a verb in the first
group, an empty tense list, padded regions and short sequences that force
finished beams. The eval pipeline's world is the same tiny captioner with a
small planner (hidden 32, 2 + 2 layers) and a narrow Sinkhorn net. Parameters
are made by the JAX package and reach the port through its weight bridge
(`vsrcic_tpu_torch.utils.params`).

    python tests/torch_parity.py   # rewrite vsrcic_tpu_torch/testdata/golden_{beam,pipeline}.npz
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


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    np.savez_compressed(GOLDEN, **golden_arrays())
    print("wrote", GOLDEN)
    np.savez_compressed(GOLDEN_PIPELINE, **pipeline_golden_arrays())
    print("wrote", GOLDEN_PIPELINE)
