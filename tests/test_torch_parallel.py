"""The port's data-parallel layer (`vsrcic_tpu_torch.parallel`) on gloo ranks
on the CPU, at worlds 2 and 3 (one spawn of each world runs every case of
this file; tests/torch_dist_workers.py holds the ranks' side):

  * each rank's `shard_batch` block is the same slice of JAX `shard_batch`'s
    zero-padded arrays; `replicate` gives rank 0's bits everywhere,
    `all_reduce_tree` the sum, `all_gather_blocks` the rank order; the mesh
    refuses a model axis and a world it does not have;
  * `sharded_beam_search_v` strict is token-exact against JAX's
    single-device `beam_search_v` and JAX's `sharded_beam_search_v` on a
    2-device slice of conftest's CPU mesh; through the kernels' plain
    versions on bf16 tables it gives the port's single-device beam and, on
    the beam's golden batch, JAX's Pallas kernels' results
    (vsrcic_tpu_torch/testdata/golden_beam.npz); each rank's block equals
    the single-device program on that block; `sharded_greedy` gives JAX's
    greedy words;
  * the launcher: the backend follows from the devices, rank 0's result
    and output come back, the others print nothing, and a rank that raises
    fails the run with its traceback.
"""
import contextlib
import dataclasses
import io
from types import SimpleNamespace as NS

import jax
import numpy as np
import pytest

from vsrcic_tpu.parallel import make_mesh as jax_make_mesh
from vsrcic_tpu.parallel import shard_batch as jax_shard_batch
from vsrcic_tpu.parallel import sharded_beam_search_v as jax_sharded_beam
from vsrcic_tpu_torch.parallel import launch

import torch_dist_workers as tdw
import torch_parity as tp

WORLDS = (2, 3)
B_BEAM, BEAM = 6, 3
BATCH = {"dets": np.arange(5 * 4, dtype=np.float32).reshape(5, 4),
         "ids": np.arange(5 * 2, dtype=np.int64).reshape(5, 2) - 3}
TREE = {"a": {"weight": np.linspace(-1, 1, 12, dtype=np.float32)
              .reshape(3, 4)},
        "b": np.arange(5, dtype=np.float32),
        "n": np.arange(4, dtype=np.int64)}


def beam_inputs(seed=3):
    rng = np.random.RandomState(seed)
    dets = rng.rand(B_BEAM, 6, tp.D).astype(np.float32)
    dets[:, -1] = 0.0
    groups = rng.rand(B_BEAM, tp.L, tp.M, tp.D).astype(np.float32)
    groups[:, :, -1] = 0.0
    vl = np.where(rng.rand(B_BEAM, tp.L) < 0.4, rng.randint(1, 3, (
        B_BEAM, tp.L)), -1).astype(np.int64)
    return dets, groups, vl


@pytest.fixture(scope="module")
def golden():
    """The beam's golden fixture: JAX-made weights, a batch of 4 and
    JAX's results on it (strict, and Pallas kernels on bf16 tables)."""
    from vsrcic_tpu_torch.utils.params import unflatten
    with np.load(tp.GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    g["params"] = unflatten({k[len("param/"):]: v for k, v in g.items()
                             if k.startswith("param/")})
    return g


def beam_runs(golden, n):
    """{run: inputs} of the beam case: B_BEAM rows strict and through the
    kernels' plain versions on bf16 tables, and the golden batch's first
    rows (as many as divide by n) on bf16 tables."""
    dets, groups, vl = beam_inputs()
    runs = {name: dict(fast=fast, dets=dets, groups=groups, verb_list=vl,
                       beam_size=BEAM)
            for name, fast in (("strict", None), ("bf16", "bf16"))}
    k = golden_rows(golden, n)
    runs["golden"] = dict(fast="bf16", dets=golden["detections"][:k],
                          groups=golden["det_groups"][:k],
                          verb_list=golden["verb_list"][:k],
                          beam_size=int(golden["beam_size"]))
    return runs


def golden_rows(golden, n):
    return len(golden["detections"]) // n * n


@pytest.fixture(scope="module", params=WORLDS, ids=["world2", "world3"])
def world(request, golden, tmp_path_factory):
    """(n, every case's per-rank results, what the run printed)."""
    n = request.param
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tdw.run_world(
            n, tmp_path_factory.mktemp("parallel"),
            mesh=dict(batch=BATCH, tree=TREE),
            beam=dict(cfg=dataclasses.asdict(tp.torch_cfg()),
                      params=golden["params"], verbs=tp.VERB_TABLE,
                      runs=beam_runs(golden, n), eos=tp.EOS))
    return n, res, buf.getvalue()


@pytest.fixture(scope="module")
def want(golden):
    """The beams each run must give: JAX's single-device strict beam (and
    JAX's sharded one on 2 devices, and its greedy words), the port's
    single-device beam through the plain versions on bf16 tables (held to
    JAX's Pallas kernels by tests/test_torch_beam.py) and JAX's golden
    results."""
    dets, groups, vl = beam_inputs()
    params = golden["params"]
    cap = tp.jax_captioner(params)
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    bf16 = tp.torch_captioner(params, "bf16").beam_search_v(
        dets, groups, vl, eos_word=tp.EOS, beam_size=BEAM)
    return {
        "strict": tp.result_arrays(cap.beam_search_v(
            dets, groups, vl, eos_word=tp.EOS, beam_size=BEAM)),
        "jax_sharded": tp.result_arrays(jax_sharded_beam(
            cap, mesh, dets, groups, vl, eos_word=tp.EOS, beam_size=BEAM)),
        "greedy": [np.asarray(x) for x in cap.test(dets, groups)],
        "bf16": tp.result_arrays(bf16),
        "golden": {f: golden["fast_bf16/" + f] for f in tp.RESULT_FIELDS}}


def test_shard_batch_blocks_match_jax(world):
    n, res, _ = world
    mesh = jax_make_mesh(n_data=n, devices=jax.devices()[:n])
    want = {k: np.asarray(v) for k, v in jax_shard_batch(BATCH, mesh).items()}
    per = want["dets"].shape[0] // n
    for r, rank in enumerate(res["mesh"]):
        for k in BATCH:
            np.testing.assert_array_equal(rank["block/" + k],
                                          want[k][r * per:(r + 1) * per])


def test_collectives(world):
    n, res, _ = world
    total = sum(range(1, n + 1))
    for r, rank in enumerate(res["mesh"]):
        for k in ("a.weight", "b", "n"):
            leaf = TREE["a"]["weight"] if k == "a.weight" else TREE[k]
            np.testing.assert_array_equal(rank["replicated/" + k], leaf)
            np.testing.assert_allclose(rank["summed/" + k], leaf * total,
                                       rtol=1e-6)
            np.testing.assert_array_equal(rank["summed/" + k],
                                          res["mesh"][0]["summed/" + k])
        np.testing.assert_array_equal(
            rank["gathered"], np.repeat(np.arange(n, dtype=np.float32),
                                        2)[:, None] * np.ones(3))
        assert "n_model must be 1" in str(rank["refused/model_axis"])
        assert "differs from the world size" in str(rank["refused/world"])
    assert res["mesh"][0]["__result__"] == "rank 0's result"


@pytest.mark.parametrize("run", ["strict", "bf16", "golden"])
def test_sharded_beam(world, want, run):
    """Every rank's whole result is the single-device beam's (JAX's for
    the strict and golden runs), and each rank's block is the
    single-device program run on that block alone."""
    n, res, _ = world
    expect = want[run]
    if run == "golden":     # each item's beam is its own: JAX's first rows
        k = len(res["beam"][0]["golden/words"])
        expect = {f: v[:k] for f, v in expect.items()}
    lo = 0
    for rank in res["beam"]:
        got = {f: rank["%s/%s" % (run, f)] for f in tp.RESULT_FIELDS}
        tp.assert_beams_match(NS(**got), NS(**expect))
        k = len(rank["%s/own/words" % run])
        for f in tp.RESULT_FIELDS:
            np.testing.assert_array_equal(rank["%s/own/%s" % (run, f)],
                                          got[f][lo:lo + k])
        lo += k
    assert lo == len(expect["words"])


def test_sharded_beam_matches_jax_sharded(world, want):
    _, res, _ = world
    got = {f: res["beam"][0]["strict/" + f] for f in tp.RESULT_FIELDS}
    tp.assert_beams_match(NS(**got), NS(**want["jax_sharded"]))


def test_sharded_greedy_matches_jax(world, want):
    _, res, _ = world
    for rank in res["beam"]:
        np.testing.assert_array_equal(rank["greedy/words"],
                                      want["greedy"][0])
        np.testing.assert_array_equal(rank["greedy/gates"],
                                      want["greedy"][1])


def test_launcher_relays_rank0_output(world):
    n, res, out = world
    ranks = ", ".join("%d:cpu" % r for r in range(n))
    assert "data parallel: gloo, ranks %s" % ranks in out
    assert "rank 0 prints" in out and "rank 1 prints" not in out
    assert res["mesh"][0]["__result__"] == "rank 0's result"


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        tdw.run_world(2, tmp_path, fail={})


@pytest.mark.parametrize("devices,backend", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"), (["cuda:0"], "nccl")])
def test_backend_follows_the_devices(devices, backend):
    assert launch.backend_for(devices) == backend


def test_backend_refuses_a_mix():
    with pytest.raises(ValueError, match="all the CPU or all CUDA"):
        launch.backend_for(["cpu", "cuda:0"])
