"""The generators: the same inputs for the same seed, other values for
another seed, the same sizes for every seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vsrbench import harness, layout
from vsrbench.drivers import eval_stream, xe_train
from vsrbench.tests.tiny import tiny_root

SEEDS = (7, 2 ** 31 + 11, 2 ** 40 + 3)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def eval_batch(root, seed, index=0):
    cell = layout.cell("vsr-coco.stream-b512", root)
    return eval_stream.make_batch(cell.config, cell.traffic, seed, index,
                                  torch.device("cpu"))


def xe_batch(root, seed, index=0):
    cell = layout.cell("captioner-coco.xe-b1024", root)
    return xe_train.make_batch(cell.config, cell.traffic, seed, index,
                               torch.device("cpu"))


def eval_arrays(b):
    return [np.asarray(x) for x in b.fields] + [
        t.numpy() for t in (b.dets, b.seqs) + b.feats]


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_same_seed_same_inputs(root, seed):
    a, b = eval_arrays(eval_batch(root, seed)), eval_arrays(eval_batch(root, seed))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_eval_seeds_differ_in_values_not_sizes(root):
    cell = layout.cell("vsr-coco.stream-b512", root)
    got = [eval_batch(root, s) for s in SEEDS]
    for x, y in zip(got, got[1:]):
        ax, ay = eval_arrays(x), eval_arrays(y)
        assert [a.shape for a in ax] == [a.shape for a in ay]
        assert not np.array_equal(ax[0], ay[0])       # verbs
        assert not np.array_equal(ax[4], ay[4])       # detections
    for b in got:
        cv, dv, dsr, vl = b.fields
        # sizes: verbs a job by the pattern, slots a verb, one verb slot each
        pattern = cell.traffic["verbs_per_job"]
        n_verbs = (cv != 0).sum(1)
        assert list(n_verbs) == [pattern[p % len(pattern)]
                                 for p in range(len(cv))]
        assert ((dv[:, :, 0] != 0).sum(1)
                == n_verbs * eval_stream.slots_per_verb(cell.traffic)).all()
        assert ((vl[:, :, 0] != -1).sum(1) == n_verbs).all()
        assert (b.dets.abs().sum(-1) != 0).sum(1).min() >= \
            cell.traffic["real_detections"][0]
    shapes = [eval_stream.shape_of(cell.config, cell.traffic)] * 2
    assert shapes[0] == shapes[1]


def test_eval_pool_batches_differ(root):
    a, b = eval_arrays(eval_batch(root, 5, 0)), eval_arrays(eval_batch(root, 5, 1))
    assert not np.array_equal(a[4], b[4])


@pytest.mark.parametrize("seed", SEEDS)
def test_xe_same_seed_same_inputs(root, seed):
    a, b = xe_batch(root, seed), xe_batch(root, seed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_xe_seeds_differ_in_values_not_sizes(root):
    cell = layout.cell("captioner-coco.xe-b1024", root)
    got = [xe_batch(root, s) for s in SEEDS]
    for x, y in zip(got, got[1:]):
        assert [t.shape for t in x] == [t.shape for t in y]
        assert not torch.equal(x[0], y[0]) and not torch.equal(x[1], y[1])
    tr, data = cell.traffic, cell.config["data"]
    for det, caps, ids, gates in got:
        eos = (caps == data["eos_word"]).float().argmax(1)
        assert eos.min() >= tr["caption_words"][0] + 1
        assert eos.max() <= tr["caption_words"][1] + 1
        per_step = (ids >= 0).sum(-1)
        assert per_step.min() >= 1
        assert ((gates == -1) == (torch.arange(caps.shape[1])[None, :]
                                  > eos[:, None])).all()


def test_weights_same_seed(root):
    cell = layout.cell("vsr-coco.stream-b512", root)
    a = eval_stream.make_weights(cell.config, 9, torch.device("cpu"))
    b = eval_stream.make_weights(cell.config, 9, torch.device("cpu"))
    c = eval_stream.make_weights(cell.config, 10, torch.device("cpu"))
    wa, wb, wc = (harness_flat(x["captioner"]) for x in (a, b, c))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not torch.equal(wa["out_fc.weight"], wc["out_fc.weight"])
    assert np.array_equal(a["tense_ids"], b["tense_ids"])


def harness_flat(tree):
    return xe_train.flat(tree)


def test_seed_streams_are_whole_numbers():
    assert harness.numpy_rng(2 ** 31 + 5, 1).integers(1 << 30) != \
        harness.numpy_rng(5, 1).integers(1 << 30)
