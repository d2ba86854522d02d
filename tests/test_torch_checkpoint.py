"""Checkpoints, configs and reference weights across the two packages.

The npz layout is the route between them: a checkpoint that JAX's
`_save_npz` writes restores in the port and decodes JAX's words, and the
port's `save_checkpoint` writes what JAX's `_load_npz` reads back as the
same tree. A reference-layout state dict saved with `torch.save` imports
to the same tree in both packages. An orbax directory (JAX's
`save_checkpoint` writes one when orbax is installed) is refused with a
message that names the npz route. `CheckpointManager` keeps JAX's best/last
files, journal and patience. The config tree round-trips.
"""
import json
import os

import numpy as np
import pytest
import torch

from vsrcic_tpu.core import checkpoint as jax_ckpt
from vsrcic_tpu.core import config as jax_config
from vsrcic_tpu.utils import torch_import as jax_import
from vsrcic_tpu_torch.core import checkpoint as torch_ckpt
from vsrcic_tpu_torch.core import config as torch_config
from vsrcic_tpu_torch.utils import torch_import as torch_import_
from vsrcic_tpu_torch.utils.params import flatten

import torch_parity as tp


def assert_trees_equal(got, want):
    assert sorted(flatten(got)) == sorted(flatten(want))
    for k, w in flatten(want).items():
        g = flatten(got)[k]
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_jax_npz_restores_and_decodes_jax_words(tmp_path):
    params = tp.to_numpy_tree(tp.jax_params(seed=4))
    path = str(tmp_path / "cap")
    jax_ckpt._save_npz(path, {"params": params, "step": np.asarray(3),
                              "cfg": {"rnn_size": np.asarray(tp.R)}})
    blob = torch_ckpt.restore_checkpoint(path)
    assert int(blob["cfg"]["rnn_size"]) == tp.R and int(blob["step"]) == 3
    assert_trees_equal(blob["params"], params)
    on_cpu = torch_ckpt.restore_checkpoint(path, device="cpu")
    assert isinstance(on_cpu["params"]["out_fc"]["weight"], torch.Tensor)
    assert_trees_equal(on_cpu["params"], params)

    detections, groups, verb_list = tp.inputs(1)
    want = tp.jax_captioner(params).beam_search_v(
        detections, groups, verb_list, eos_word=tp.EOS, beam_size=3)
    got = tp.torch_captioner(blob["params"]).beam_search_v(
        detections, groups, verb_list, eos_word=tp.EOS, beam_size=3)
    tp.assert_beams_match(got, want)


def test_port_npz_restores_in_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"a": {"weight": torch.randn(3, 4, generator=g),
                             "bias": torch.zeros(4)},
                       "emb": torch.randn(5, 2, generator=g).to(
                           torch.bfloat16)},
            "opt_state": [torch.arange(3), {"mu": torch.ones(2)}],
            "step": 7, "cfg": {"tau": np.asarray(0.1),
                               "h2_first_lstm": np.asarray(True)}}
    path = str(tmp_path / "x")
    torch_ckpt.save_checkpoint(path, tree)
    got = jax_ckpt._load_npz(path)
    want = {"params": {"a": {"weight": tree["params"]["a"]["weight"].numpy(),
                             "bias": np.zeros(4, np.float32)},
                       "emb": tree["params"]["emb"].float().numpy()},
            "opt_state": {"#0": np.arange(3),
                          "#1": {"mu": np.ones(2, np.float32)}},
            "step": np.asarray(7),
            "cfg": {"tau": np.asarray(0.1),
                    "h2_first_lstm": np.asarray(True)}}
    assert_trees_equal(got, want)
    # and the port reads its own file back the same way
    assert_trees_equal(torch_ckpt.restore_checkpoint(path), want)


def test_reference_state_dict_imports_alike(tmp_path):
    """A reference-layout .pth (the captioner's training dict with its
    state_dict inside, and a bare planner state dict) imports to the same
    tree in both packages."""
    params = tp.to_numpy_tree(tp.jax_params(seed=2))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in flatten(params).items()}
    for name, blob in (("train.pth", {"epoch": 3, "state_dict": sd}),
                       ("model-sh.pth", sd)):
        path = str(tmp_path / name)
        torch.save(blob, path)
        got = torch_import_.import_torch_state_dict(path)
        want = jax_import.import_torch_state_dict(path)
        assert_trees_equal(got, tp.to_numpy_tree(want))
        assert_trees_equal(got, params)


def test_orbax_directory_is_refused(tmp_path):
    path = tmp_path / "orbax_ckpt"
    path.mkdir()
    with pytest.raises(ValueError, match="npz"):
        torch_ckpt.restore_checkpoint(str(path))


def test_checkpoint_manager_matches_jax(tmp_path, monkeypatch):
    """Over the same metric sequence both managers write the same files,
    the same journal, and run out of patience at the same step. JAX's
    writes npz here (orbax hidden), as it does where orbax is absent."""
    import builtins
    real_import = builtins.__import__

    def no_orbax(name, *a, **kw):
        if name.startswith("orbax"):
            raise ImportError("orbax hidden for the test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_orbax)
    metrics = [0.3, 0.5, 0.5, 0.4, 0.2, 0.45, 0.1]
    out = {}
    for pkg, mod in (("jax", jax_ckpt), ("torch", torch_ckpt)):
        root = str(tmp_path / pkg)
        mgr = mod.CheckpointManager(root, "exp")
        stops = []
        for e, m in enumerate(metrics):
            tree = {"params": {"w": np.full((2,), m, np.float32)},
                    "epoch": np.asarray(e)}
            stops.append(mgr.step(tree, m, e, patience_limit=3))
        with open(os.path.join(root, "exp_meta.json")) as f:
            meta = json.load(f)
        best = mod._load_npz(os.path.join(root, "exp_best"))
        last = mod._load_npz(os.path.join(root, "exp_last"))
        out[pkg] = (sorted(os.listdir(root)), stops, meta, best, last)
        # a manager reopened on the same root resumes from the journal
        assert mod.CheckpointManager(root, "exp").meta == meta
    got, want = out["torch"], out["jax"]
    assert got[:3] == want[:3]
    # 0.5 again is a new best (>=); three misses in a row end the run
    assert want[1] == [False, False, False, False, False, True, True]
    assert want[2]["best_metric"] == 0.5 and want[2]["patience"] == 4
    assert_trees_equal(got[3], want[3])
    assert_trees_equal(got[4], want[4])
    assert float(got[3]["params"]["w"][0]) == 0.5
    restored = torch_ckpt.CheckpointManager(str(tmp_path / "torch"),
                                            "exp").restore(best=False)
    assert_trees_equal(restored, want[4])


def test_config_round_trips(tmp_path):
    """The config tree serialises to JAX's dict, and a file written by
    either package loads in the other."""
    cfg = torch_config.CaptionerPipelineConfig(sample_rl=True)
    jcfg = jax_config.CaptionerPipelineConfig(sample_rl=True)
    assert torch_config.to_dict(cfg) == jax_config.to_dict(jcfg)
    for cls in ("CaptionerPipelineConfig", "PlannerPipelineConfig",
                "EvalPipelineConfig"):
        path = str(tmp_path / (cls + ".json"))
        torch_config.save_config(getattr(torch_config, cls)(), path)
        back = torch_config.load_config(getattr(torch_config, cls), path)
        assert back == getattr(torch_config, cls)()
        assert (jax_config.to_dict(jax_config.load_config(
            getattr(jax_config, cls), path))
            == torch_config.to_dict(back))
    assert type(back.data).__module__ == "vsrcic_tpu_torch.core.config"
    assert type(torch_config.PlannerPipelineConfig().ssp).__module__ == \
        "vsrcic_tpu_torch.models.s_ssp"
