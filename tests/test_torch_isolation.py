"""The port imports neither JAX nor the JAX package: every module of
`vsrcic_tpu_torch`, and chip_smoke.py, imports in a process whose import
system refuses the top-level names `jax`, `jaxlib`, `optax` and
`vsrcic_tpu` (compared exactly: `vsrcic_tpu_torch` shares the prefix).

Nor does it read a file of the JAX package or of its `native/` directory:
an audit hook records every path opened, listed, loaded or handed to a
subprocess while the port's modules and chip_smoke.py import and while the
two host libraries, the native CIDEr-D scorer and the packed-store reader,
are built from scratch and used."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BANNED = {"jax", "jaxlib", "optax", "vsrcic_tpu"}
refused = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            refused.append(name)
            raise ImportError("refused: " + name)
        return None


for name in list(sys.modules):
    if name.split(".")[0] in BANNED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import vsrcic_tpu_torch
names = ["vsrcic_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(vsrcic_tpu_torch.__path__,
                                          "vsrcic_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not refused, refused
print("IMPORTED", len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split("IMPORTED")[1])
    assert n >= 10  # the package, its subpackages and their modules


READS = r"""
import importlib, importlib.util, os, pkgutil, sys, tempfile
from pathlib import Path

REPO = Path(os.getcwd()).resolve()
seen = []


def record(path):
    if isinstance(path, (str, bytes, os.PathLike)):
        p = os.fsdecode(path)
        if os.sep in p:
            seen.append(p)


def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir", "glob.glob",
                 "ctypes.dlopen"):
        record(args[0])
    elif event == "subprocess.Popen":
        for a in [args[0]] + list(args[1] or []):
            record(a)


sys.addaudithook(hook)
import vsrcic_tpu_torch
for m in pkgutil.walk_packages(vsrcic_tpu_torch.__path__,
                               "vsrcic_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

import numpy as np
from vsrcic_tpu_torch.data import native_reader
from vsrcic_tpu_torch.metrics import cider_native
from vsrcic_tpu_torch.metrics.cider import Cider
from vsrcic_tpu_torch.ops import _build
with tempfile.TemporaryDirectory() as tmp:
    _build.BUILD = Path(tmp)                 # a build from scratch
    cider_native._load.cache_clear()
    native_reader._load_lib.cache_clear()
    nat = cider_native.NativeCiderPair(Cider(gts=["a dog runs", "a cat"]))
    print("SCORES", list(nat.score_pair(["a dog"], ["a dog"], ["a cat"])[0]))
    src = np.arange(12, dtype=np.float32).reshape(6, 2)
    rows = native_reader.fill_padded_batch(src, [1, 3], [2, 3], 3)
    assert rows.sum() == src[1:3].sum() + src[3:6].sum(), rows
    print("ROWS", rows.shape)
    built = [p for p in seen if p.endswith(".cpp")]

bad = []
for p in seen:
    q = Path(p)
    q = (q if q.is_absolute() else REPO / q).resolve()
    if q.is_relative_to(REPO) and q.relative_to(REPO).parts[:1] in (
            ("native",), ("vsrcic_tpu",)):
        bad.append(p)
assert not bad, bad
csrc = REPO / "vsrcic_tpu_torch" / "csrc"
assert sorted({Path(p).resolve() for p in built}) == [
    csrc / "cider_scorer.cpp", csrc / "packed_reader.cpp"], built
print("PATHS", len(seen))
"""


def test_port_reads_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", READS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split("PATHS")[1]) > 100
    assert "SCORES" in res.stdout and "ROWS" in res.stdout
