"""The port's data layer (`vsrcic_tpu_torch.data`, `cli/common.py`,
`cli/fields.py`) against the JAX package's, exactly (tolerance 0: both
sides run the same numpy code on the same seeds).

On the synthetic COCO and Flickr worlds at two seeds: the splits'
examples, the vocabulary, `verb_2_vob_all` and every side table; every
array of every eval field on the whole test split (image field, the eval
detection field with det and gt each on or off, `unpack_eval_output`);
the planner trainers' fields; DataLoader batches. The fields draw from
Python's `random`, so each side is seeded by its own `seed_all` and
preprocesses in the same order, with no worker threads.

A packed store written here from an HDF5 file: the port's converter writes
the JAX converter's bytes (bf16 rounding included, without `ml_dtypes`),
and its native reader gives `batch_features`'s batches, a bf16 store's
widened to f32. The HDF5 store reads through `h5py`.
"""
import argparse
import os

import numpy as np
import pytest

from vsrcic_tpu.cli import common as jax_common
from vsrcic_tpu.cli import fields as jax_fields
from vsrcic_tpu.data import dataset as jax_dataset
from vsrcic_tpu.data import native_reader as jax_reader
from vsrcic_tpu.data import store as jax_store
from vsrcic_tpu_torch.cli import common as torch_common
from vsrcic_tpu_torch.cli import fields as torch_fields
from vsrcic_tpu_torch.data import dataset as torch_dataset
from vsrcic_tpu_torch.data import native_reader as torch_reader
from vsrcic_tpu_torch.data import store as torch_store

WORLDS = [("coco", 0), ("coco", 5), ("flickr", 0), ("flickr", 5)]


def make_opt(dataset, seed, **kw):
    return argparse.Namespace(**dict(dict(
        dataset=dataset, synthetic=True, synthetic_images=24, feat_dim=32,
        seed=seed, fixed_len=10, det=False, gt=False), **kw))


def assert_same(got, want, path="x"):
    """Equal structure, types of arrays and values, recursively; examples
    (a class of each package) compare by their attributes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], "%s[%r]" % (path, k))
    elif isinstance(want, (list, tuple)):
        assert type(got).__name__ == type(want).__name__, path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, jax_dataset.Example):
        assert isinstance(got, torch_dataset.Example), path
        assert_same(vars(got), vars(want), path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module", params=WORLDS,
                ids=["%s-%d" % w for w in WORLDS])
def worlds(request):
    ds, seed = request.param
    return (make_opt(ds, seed), jax_common.build_world(make_opt(ds, seed)),
            torch_common.build_world(make_opt(ds, seed)))


def test_worlds_match(worlds):
    _, want, got = worlds
    assert type(got).__name__ == type(want).__name__
    assert list(got.text_field.vocab.itos) == list(want.text_field.vocab.itos)
    assert got.verb_2_vob_all == want.verb_2_vob_all
    assert_same(got.splits, want.splits, "splits")
    for name in vars(want):
        if name not in ("store", "text_field", "splits", "classes",
                        "vectors"):
            assert_same(getattr(got, name), getattr(want, name), name)
    assert_same(got.classes, want.classes, "classes")
    assert_same(got.vectors, want.vectors, "vectors")
    for ex in want.splits[2][:4]:
        assert_same(tuple(got.store.get(ex.image)),
                    tuple(want.store.get(ex.image)), "store")


def preprocess_all(common, field, examples, attr, seed):
    common.seed_all(seed)
    return [field.preprocess(getattr(ex, attr)) for ex in examples]


@pytest.mark.parametrize("det,gt", [(False, False), (False, True),
                                    (True, False), (True, True)])
def test_eval_fields_match(worlds, det, gt):
    opt, want_w, got_w = worlds
    opt = make_opt(opt.dataset, opt.seed, det=det, gt=gt)
    test = want_w.splits[2]
    for make in ("make_image_field", "make_eval_det_field"):
        attr = "image" if make == "make_image_field" else "detection"
        want = preprocess_all(jax_common, getattr(jax_fields, make)(
            want_w, opt), test, attr, opt.seed)
        got = preprocess_all(torch_common, getattr(torch_fields, make)(
            got_w, opt), test, attr, opt.seed)
        assert_same(got, want, make)
    assert len(got) == len(test)
    for g, w in zip(got, want):
        assert_same(torch_fields.unpack_eval_output(g, opt.dataset, det),
                    jax_fields.unpack_eval_output(w, opt.dataset, det),
                    "unpack_eval_output")


def test_planner_training_fields_match(worlds):
    opt, want_w, got_w = worlds
    train = want_w.splits[0][:24]
    for make in ("make_ssp_det_field", "make_sinkhorn_det_field"):
        want = preprocess_all(jax_common, getattr(jax_fields, make)(
            want_w, opt), train, "detection", opt.seed)
        got = preprocess_all(torch_common, getattr(torch_fields, make)(
            got_w, opt), train, "detection", opt.seed)
        assert_same(got, want, make)


def loader_batches(pkg_data, pkg_common, pkg_fields, world, opt, shuffle):
    from importlib import import_module
    data = import_module(pkg_data)
    if shuffle:
        ds = data.PairedDataset(world.splits[0], {
            "image": pkg_fields.make_image_field(world, opt),
            "detection": pkg_fields.make_ssp_det_field(world, opt)})
    else:
        ds = data.DictionaryDataset(world.splits[2], {
            "image": pkg_fields.make_image_field(world, opt),
            "detection": pkg_fields.make_eval_det_field(world, opt),
            "text": data.RawField()}, "image")
    pkg_common.seed_all(opt.seed)
    return list(data.DataLoader(ds, batch_size=2, shuffle=shuffle,
                                num_workers=0, seed=opt.seed))


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match(worlds, shuffle):
    opt, want_w, got_w = worlds
    want = loader_batches("vsrcic_tpu.data", jax_common, jax_fields, want_w,
                          opt, shuffle)
    got = loader_batches("vsrcic_tpu_torch.data", torch_common, torch_fields,
                         got_w, opt, shuffle)
    assert len(got) == len(want) > 1
    assert_same(got, want, "batches")


# ---------------------------------------------------------------------------
# packed and HDF5 stores
# ---------------------------------------------------------------------------

def write_hdf5(path, ids_rows, dim=16, n_classes=6, seed=3):
    import h5py
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for i, n in ids_rows:
            f["%d_cls_prob" % i] = rng.rand(n, n_classes).astype(np.float32)
            feats = rng.randn(n, dim).astype(np.float32)
            feats[0, :4] = [np.nan, np.inf, -0.0, 1e-40]  # edge values
            f["%d_features" % i] = feats
            f["%d_boxes" % i] = rng.rand(n, 4).astype(np.float32)
    return str(path)


IDS_ROWS = [(1, 5), (2, 9), (3, 1), (4, 12), (5, 7)]


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """{dtype: (JAX store, port store)} converted from one HDF5 file."""
    tmp = tmp_path_factory.mktemp("packed")
    h5 = write_hdf5(tmp / "d.hdf5", IDS_ROWS)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = (
            jax_store.PackedFeatureStore.convert_hdf5(
                h5, str(tmp / ("jax_" + dtype)), dtype=dtype),
            torch_store.PackedFeatureStore.convert_hdf5(
                h5, str(tmp / ("torch_" + dtype)), dtype=dtype))
    out["hdf5"] = h5
    return out


def widened(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_store_matches_jax(packed, dtype):
    want, got = packed[dtype]
    for name in ("features.bin", "cls_probs.bin", "boxes.bin"):
        with open(os.path.join(want.root, name), "rb") as f:
            want_bytes = f.read()
        with open(os.path.join(got.root, name), "rb") as f:
            assert f.read() == want_bytes, name   # bf16 rounding included
    assert got.index == want.index
    for i, _ in IDS_ROWS:
        for g, w in zip(got.get(i), want.get(i)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, widened(w))
    ids = [4, 1, 3, 5, 2, 2]
    for max_rows in (8, 16):
        w = jax_reader.batch_features(want, ids, max_rows)
        g = torch_reader.batch_features(got, ids, max_rows)
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, widened(w))


def test_native_reader_matches_plain_version():
    """The native gather against its numpy version (f32 and 2-byte rows,
    ragged and clipped counts, one thread and several), and the checks
    that keep a bad range away from the C++ side."""
    rng = np.random.RandomState(0)
    src = rng.rand(400, 24).astype(np.float32)
    starts = list(range(0, 400, 7))
    counts = [int(c) for c in rng.randint(0, 9, len(starts))]
    counts[-1] = 1
    for s in (src, src.view(np.uint16)):
        for nthreads in (1, 4):
            got = torch_reader.fill_padded_batch(s, starts, counts, 6,
                                                 nthreads=nthreads)
            want = torch_reader.fill_padded_batch_plain(s, starts, counts, 6)
            assert got.dtype == s.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        torch_reader.fill_padded_batch(src, [399], [2], 4)
    with pytest.raises(ValueError, match="even width"):
        torch_reader.fill_padded_batch(np.zeros((4, 3), np.uint16), [0],
                                       [1], 2)
    assert torch_reader.native_available()


def test_image_field_batches_match_jax(packed):
    from vsrcic_tpu.data import ImageDetectionsField as JaxField
    from vsrcic_tpu_torch.data import ImageDetectionsField as TorchField
    paths = ["imgs/COCO_train2014_%012d.jpg" % i for i, _ in IDS_ROWS]
    for dtype in ("float32", "bfloat16"):
        want_s, got_s = packed[dtype]
        want = JaxField(want_s, max_detections=10).preprocess_batch(paths)
        got = TorchField(got_s, max_detections=10).preprocess_batch(paths)
        for (g, gi), (w, wi) in zip(got, want):
            assert gi == wi and g.dtype == np.float32
            np.testing.assert_array_equal(g, widened(w))
        # the per-item path gives the batch path's f32 values
        field = TorchField(got_s, max_detections=10)
        for (g, _), x in zip(got, paths):
            np.testing.assert_array_equal(g, field.preprocess(x)[0])


def test_hdf5_store_matches_jax(packed):
    want = jax_store.HDF5FeatureStore(packed["hdf5"])
    got = torch_store.HDF5FeatureStore(packed["hdf5"])
    assert list(got.keys()) == list(want.keys())
    for i, _ in IDS_ROWS:
        assert_same(tuple(got.get(i)), tuple(want.get(i)), "hdf5")
    with pytest.warns(UserWarning, match="Could not find"):
        rec = got.get(99)
    assert rec.features.shape == (10, 2048)


def test_bf16_bits_round_trip():
    """f32 -> bf16 bits rounds to nearest even like ml_dtypes, and the
    widening is exact."""
    import ml_dtypes
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(4096).astype(np.float32) * 10.0 ** rng.
                        randint(-30, 30, 4096), np.float32(
                            [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45,
                             3.3895314e38, 1.00390625, 1.01171875])])
    x = x.astype(np.float32)
    bits = torch_store.f32_to_bf16_bits(x)
    want = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(bits, want.view(np.uint16))
    np.testing.assert_array_equal(torch_store.bf16_bits_to_f32(bits),
                                  want.astype(np.float32))


def test_cuda_put_moves_arrays_and_keeps_the_rest():
    """DevicePrefetchLoader's put_fn: numeric arrays become tensors on the
    device (here the CPU), through dicts, lists, tuples and named tuples;
    ids and strings stay as they are; the batches keep their order."""
    import functools
    import torch
    from vsrcic_tpu_torch.data import DevicePrefetchLoader
    from vsrcic_tpu_torch.data.loader import cuda_put
    batch = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
             "ids": ["a", "b"],
             "rec": torch_store.DetRecord(np.ones(2), np.zeros((1, 2)),
                                          np.full(4, 2.0)),
             "pair": (np.int64(3), np.array([1, 2]))}
    out = cuda_put(batch, "cpu")
    assert isinstance(out["x"], torch.Tensor) and out["x"].dtype == \
        torch.float32
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"])
    assert out["ids"] == ["a", "b"]
    assert isinstance(out["rec"], torch_store.DetRecord)
    assert torch.equal(out["rec"].boxes, torch.full((4,), 2.0,
                                                    dtype=torch.float64))
    assert out["pair"][0] == 3 and torch.equal(out["pair"][1],
                                               torch.tensor([1, 2]))
    loader = DevicePrefetchLoader(
        [{"x": np.full(2, i, np.float32)} for i in range(5)],
        functools.partial(cuda_put, device="cpu"), depth=2)
    assert [int(b["x"][0]) for b in loader] == list(range(5))
