"""The port imports neither JAX nor the JAX package: every module of
`vsrcic_tpu_torch`, and chip_smoke.py, imports in a process whose import
system refuses the top-level names `jax`, `jaxlib`, `optax` and
`vsrcic_tpu` (compared exactly: `vsrcic_tpu_torch` shares the prefix)."""
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
