"""`EvalPipeline(mesh=...)` of the port on gloo ranks on the CPU, at worlds
2 and 3 (one spawn of each world; tests/torch_dist_workers.py holds the
ranks' side), on the eval pipeline's golden fixture
(vsrcic_tpu_torch/testdata/golden_pipeline.npz): its first 3 jobs (a shared
role for the Sinkhorn net, two verbs for the rank merge, a role on 12
slots), its 7 jobs and its 3 jobs without verb groups. No job count
divides by both worlds, so every device phase takes its pad path: the
planner's groups, the Sinkhorn pairs, the recons' jobs and the beam.

Strict and through the kernels' plain versions on bf16 tables, every rank's
`run_batch` and `run_stream` words are JAX's single-device words exactly
(each job's plan and beam are its own, so the first 3 jobs' words are the
first 3 rows of the 7 jobs'), and `plan_batch`'s gathered recons are the
port's single-device ones.
"""
import dataclasses

import numpy as np
import pytest

from vsrcic_tpu_torch.pipelines import CaptionJob

import torch_dist_workers as tdw
import torch_parity as tp

WORLDS = (2, 3)


@pytest.fixture(scope="module")
def golden():
    params, cfg, batches, g = tp.load_golden_pipeline()
    batches = [{f: v[:3] for f, v in batches[0].items()}] + batches
    words = {}
    for path in ("strict", "fast_bf16"):
        b0, b1 = (g["%s/b%d/words" % (path, b)] for b in (0, 1))
        words[path] = [b0[:3], b0, b1]
    return params, cfg, batches, words


@pytest.fixture(scope="module", params=WORLDS, ids=["world2", "world3"])
def world(request, golden, tmp_path_factory):
    n = request.param
    params, cfg, batches, _ = golden
    res = tdw.run_world(
        n, tmp_path_factory.mktemp("parallel_pipeline"),
        pipeline=dict(
            cfg=cfg["captioner"], verbs=tp.VERB_TABLE, params=params,
            ssp_cfg=dataclasses.asdict(tp.ssp_cfg("torch")),
            sink_cfg=dataclasses.asdict(tp.sink_cfg("torch")), eos=tp.EOS,
            beam_size=tp.PL_BEAM,
            batches=[(b["detections"], {f: b[f] for f in tp.JOB_FIELDS})
                     for b in batches]))
    return n, res["pipeline"]


@pytest.mark.parametrize("path", ["strict", "fast_bf16"])
def test_words_are_jax_single_device_words(world, golden, path):
    _, ranks = world
    want = golden[3][path]
    for rank in ranks:
        for b, w in enumerate(want):
            np.testing.assert_array_equal(rank["%s/b%d/words" % (path, b)], w)
            np.testing.assert_array_equal(rank["%s/b%d/stream" % (path, b)],
                                          w)


@pytest.mark.parametrize("path", ["strict", "fast_bf16"])
def test_recons_are_single_device_recons(world, golden, path):
    _, ranks = world
    params, _, batches, _ = golden
    pipe = tp.torch_pipeline(params, None if path == "strict" else "bf16")
    for b, fields in enumerate(batches):
        want = pipe.plan_batch(tp.jobs_from(fields, CaptionJob))[0]
        for rank in ranks:
            np.testing.assert_array_equal(
                rank["%s/b%d/recons" % (path, b)], want)
