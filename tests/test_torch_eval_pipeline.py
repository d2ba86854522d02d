"""The port's eval plan phase and EvalPipeline against the JAX package's:
verb-group extraction, rank merge, Hungarian rounding, the recons gather,
plan_rank_batch (against JAX and against the port's own loop oracle),
run_batch / run_stream words, and the golden fixture that ties the card's
replay (chip_smoke.py phase 7) to JAX.

Tolerances: groups, ranks, verb lists, planner tokens and words identical;
Sinkhorn soft permutations within 1e-6.
"""
import itertools

import numpy as np
import pytest
import torch

from vsrcic_tpu.pipelines import CaptionJob as JaxJob
from vsrcic_tpu.pipelines import eval_pipeline as jep
from vsrcic_tpu.pipelines import sr_groups as jsr
from vsrcic_tpu.utils.rank_merge import verb_rank_merge as jax_merge
from vsrcic_tpu_torch.ops.assignment import hungarian_assign
from vsrcic_tpu_torch.pipelines import CaptionJob
from vsrcic_tpu_torch.pipelines import eval_pipeline as tep
from vsrcic_tpu_torch.pipelines import sr_groups as tsr
from vsrcic_tpu_torch.utils.rank_merge import verb_rank_merge

import torch_parity as tp


def group_grids(seed, p=9, l=10, n_sr=30):
    rng = np.random.RandomState(seed)
    cv = np.zeros((p, 8))
    for i in range(p):
        nv = rng.randint(0, 4)
        if nv:
            cv[i, :nv] = rng.choice(np.arange(1.0, 6.0), nv, replace=False)
    v = rng.choice(np.arange(0.0, 6.0), size=(p, l, 8))
    sr = rng.randint(0, n_sr, size=(p, l, 8)).astype(float)
    return cv, v, sr


@pytest.mark.parametrize("seed", range(6))
def test_verb_groups_match_jax(seed):
    """Dense grids with up to 30 distinct roles per verb, so the reference's
    truncation quirk (every match after the 10th distinct role dropped)
    fires."""
    cv, v, sr = group_grids(seed)
    want = jsr.extract_verb_groups_arrays(cv, v, sr)
    got = tsr.extract_verb_groups_arrays(cv, v, sr)
    assert (got is None) == (want is None)
    if want is not None:
        for f in ("owners", "verbs", "det_sr", "pair_group", "pair_sr",
                  "pair_off", "slot_flat"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.sr_space == want.sr_space
    wg, wo = jsr.extract_verb_groups_batch(cv, v, sr)
    gg, go = tsr.extract_verb_groups_batch(cv, v, sr)
    assert go == wo and len(gg) == len(wg)
    assert any(len(g.sr_find) == 10 for g in wg)   # truncation fired
    for g, w in zip(gg, wg):
        assert (g.verb, g.sr_find, g.need_re_rank) == (w.verb, w.sr_find,
                                                       w.need_re_rank)
        np.testing.assert_array_equal(g.det_sr_seq, w.det_sr_seq)
    for p in range(len(cv)):
        one = tsr.extract_verb_groups(cv[p], v[p], sr[p])
        ref = jsr.extract_verb_groups(cv[p], v[p], sr[p])
        assert [(g.verb, g.sr_find) for g in one] == [(g.verb, g.sr_find)
                                                       for g in ref]


def test_verb_rank_merge_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(300):
        la = list(rng.choice(12, rng.randint(0, 8), replace=False))
        lb = list(rng.choice(12, rng.randint(0, 8), replace=False))
        assert verb_rank_merge(la, lb) == jax_merge(la, lb)


def test_hungarian_matches_brute_force():
    rng = np.random.RandomState(1)
    for n in (1, 2, 4, 6):
        profit = rng.rand(5, n, n)
        got = hungarian_assign(profit)
        for p, assign in zip(profit, got):
            best = max(itertools.permutations(range(n)),
                       key=lambda perm: sum(p[i, perm[i]] for i in range(n)))
            assert list(assign) == list(best)


def test_build_recons_matches_jax():
    rng = np.random.RandomState(2)
    p, l, m, d = 6, 10, 3, 8
    seqs_all = rng.rand(p, l, m, d).astype(np.float32)
    seqs_all[rng.rand(p, l) < 0.3] = 0.0      # all-zero region groups
    rank_idx = rng.randint(0, l, (p, l)).astype(np.int32)
    rank_valid = rng.rand(p, l) < 0.7
    rank_valid[0] = False                     # nothing valid
    rank_valid[1] = True
    want = jep.EvalPipeline._build_recons_impl(seqs_all, rank_idx, rank_valid)
    got = tep.EvalPipeline._build_recons_impl(
        torch.from_numpy(seqs_all), torch.from_numpy(rank_idx).long(),
        torch.from_numpy(rank_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_bf16 = tep.EvalPipeline._build_recons_impl(
        torch.from_numpy(seqs_all).bfloat16(),
        torch.from_numpy(rank_idx).long(), torch.from_numpy(rank_valid),
        torch.from_numpy(seqs_all).sum((2, 3)))
    np.testing.assert_array_equal(got_bf16.float().numpy(),
                                  torch.from_numpy(np.array(want))
                                  .bfloat16().float().numpy())


@pytest.fixture(scope="module")
def world():
    """One JAX and one port pipeline (strict captioner) on the same
    parameters, shared so JAX compiles each program once."""
    params = tp.pipeline_params()
    return tp.jax_pipeline(params), tp.torch_pipeline(params)


def jobs_pair(fields):
    return tp.jobs_from(fields, JaxJob), tp.jobs_from(fields, CaptionJob)


def fuzz_fields(seed, n_jobs=7):
    rng = np.random.RandomState(seed)
    jobs = [tp.fuzz_job(rng) for _ in range(n_jobs)]
    return {f: np.stack([j[f] for j in jobs]) for f in tp.JOB_FIELDS}


@pytest.mark.parametrize("case", ["fuzz0", "fuzz1", "fixture", "empty",
                                  "oversized"])
def test_plan_rank_batch_matches_jax_and_loop(world, case):
    jpipe, tpipe = world
    if case.startswith("fuzz"):
        fields = fuzz_fields(int(case[-1]))
    else:
        fields = tp.pipeline_batch_fields()[1 if case == "empty" else 0]
        if case == "oversized":
            fields = {f: x[2:3] for f, x in fields.items()}
    jjobs, tjobs = jobs_pair(fields)
    want = tp.jax_plan(jpipe, jjobs)
    got = tp.torch_plan(tpipe, tjobs)
    tp.assert_plans_match(got, want, case + ": ")
    if case == "oversized":
        assert got["rank_valid"].sum() == 10 and len(got["P_soft"]) == 2
    if case == "empty":
        assert not got["rank_valid"].any() and not len(got["preds"])
    loop = tpipe.plan_rank_batch_loop(tjobs)
    np.testing.assert_array_equal(loop[1], got["rank_valid"])
    np.testing.assert_array_equal(loop[0] * loop[1],
                                  got["rank_idx"] * got["rank_valid"])
    np.testing.assert_array_equal(loop[2], got["verb_lists"])


def test_run_batch_words_match_jax(world):
    jpipe, tpipe = world
    fields = tp.pipeline_batch_fields(seed=3)[0]
    jjobs, tjobs = jobs_pair(fields)
    want = np.asarray(jpipe.run_batch(fields["detections"], jjobs))
    got = tpipe.run_batch(fields["detections"], tjobs)
    np.testing.assert_array_equal(got, want)


def test_run_stream_matches_run_batch(world):
    """The 1-ahead stream gives run_batch's words on every batch, including
    a batch with no verb groups and the final drain."""
    _, tpipe = world
    b0, b1 = tp.pipeline_batch_fields(seed=4)
    batches = [(f["detections"], tp.jobs_from(f, CaptionJob))
               for f in (b0, b1, b0)]
    seq = [tpipe.run_batch(d, j) for d, j in batches]
    staged = [(d, j, tpipe.stage_seqs_all(j), tpipe.stage_job_feats(j))
              for d, j in batches]
    for stream in (batches, staged):
        got = list(tpipe.run_stream(iter(stream)))
        assert len(got) == len(seq)
        for g, w in zip(got, seq):
            np.testing.assert_array_equal(g, w)
    assert list(tpipe.run_stream([])) == []


def test_pipeline_checks_its_device():
    """The pipeline runs on the captioner's device, the card unless asked
    otherwise; a missing card raises instead of falling back."""
    from vsrcic_tpu_torch.pipelines import EvalPipeline
    params = tp.pipeline_params()
    args = (tp.torch_captioner(params["captioner"]), params["ssp"],
            tp.ssp_cfg("torch"), params["sinkhorn"], tp.sink_cfg("torch"))
    with pytest.raises(ValueError, match="captioner runs on"):
        EvalPipeline(*args, eos_word=tp.EOS, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EvalPipeline(*args, eos_word=tp.EOS)


@pytest.mark.parametrize("path", ["strict", "fast_bf16"])
def test_golden_fixture_is_current(path):
    """Regenerating the fixture from JAX gives the committed arrays
    (rewrite it with `python tests/torch_parity.py`): the inputs and
    parameters, and `path`'s plans and words."""
    want = tp.pipeline_golden_arrays(paths=(path,))
    with np.load(tp.GOLDEN_PIPELINE) as got:
        other = "fast_bf16/" if path == "strict" else "strict/"
        assert sorted(f for f in got.files
                      if not f.startswith(other)) == sorted(want)
        for k in want:
            if k.endswith("P_soft"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", ["strict", "fast_bf16"])
def test_golden_fixture_replays_on_cpu(path):
    """The replay chip_smoke.py makes on the card (phase 7), here through
    the plain versions of the kernels: plans and words as JAX gave them,
    through run_stream over both batches and run_batch."""
    params, _, batches, g = tp.load_golden_pipeline()
    pipe = tp.torch_pipeline(params, None if path == "strict" else "bf16")
    stream = []
    for b, fields in enumerate(batches):
        jobs = tp.jobs_from(fields, CaptionJob)
        want = {f: g["%s/b%d/%s" % (path, b, f)] for f in tp.PLAN_FIELDS}
        tp.assert_plans_match(tp.torch_plan(pipe, jobs), want,
                              "%s b%d: " % (path, b))
        np.testing.assert_array_equal(
            pipe.run_batch(fields["detections"], jobs),
            g["%s/b%d/words" % (path, b)])
        stream.append((fields["detections"], jobs))
    for b, words in enumerate(pipe.run_stream(stream)):
        np.testing.assert_array_equal(words, g["%s/b%d/words" % (path, b)])
