"""Build stamps name the machine and the compiler (`ops/_build.py`).

A host library (`csrc/<stem>.cpp`) is rebuilt when the compiler's identity
or `platform.machine()` changes, and loaded as it is when neither does; a
rebuild that fails raises and never hands back the old file. The CUDA
library's stamp changes with the compiler's identity, `torch.version.cuda`
and `platform.machine()` (tested on the digest alone: this host has no
nvcc).
"""
import platform

import pytest
import torch

from vsrcic_tpu_torch.ops import _build


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    return tmp_path


def built(stem="cider_scorer"):
    lib = _build.host_library(stem)
    return lib, _build.last_host_build_seconds > 0.0


def test_host_library_rebuilt_for_another_compiler(build_dir, monkeypatch):
    lib, fresh = built()
    assert fresh and lib.parent == build_dir
    stamp = (build_dir / (lib.name + ".sha")).read_text()
    assert built() == (lib, False)                     # same compiler: kept
    real = _build.compiler_identity(_build.CXX)
    monkeypatch.setattr(_build, "compiler_identity",
                        lambda cxx: real + "\nanother release")
    assert built() == (lib, True)
    assert (build_dir / (lib.name + ".sha")).read_text() != stamp
    assert built() == (lib, False)


def test_host_library_rebuilt_on_another_machine(build_dir, monkeypatch):
    lib, _ = built("packed_reader")
    assert built("packed_reader") == (lib, False)
    monkeypatch.setattr(platform, "machine", lambda: "another-machine")
    assert built("packed_reader") == (lib, True)


def test_failed_rebuild_raises(build_dir, monkeypatch):
    """A stale library is not loaded when its rebuild fails: the build
    raises, whether the compiler is missing or refuses the source."""
    built()
    monkeypatch.setattr(_build, "CXX", str(build_dir / "no-such-c++"))
    with pytest.raises(RuntimeError, match="does not run"):
        _build.host_library("cider_scorer")
    monkeypatch.undo()
    monkeypatch.setattr(_build, "BUILD", build_dir)
    monkeypatch.setattr(_build, "CXX_FLAGS",
                        _build.CXX_FLAGS + ["-DNOT_A_FLAG", "-fno-such-flag"])
    with pytest.raises(RuntimeError, match="c.. failed"):
        _build.host_library("cider_scorer")


def test_compiler_identity_names_the_release():
    ident = _build.compiler_identity(_build.CXX)
    assert ident and any(ch.isdigit() for ch in ident.splitlines()[0])


def test_cuda_stamp_names_compiler_cuda_and_machine(monkeypatch):
    base = _build.source_hash("nvcc release 12.4")
    assert _build.source_hash("nvcc release 12.4") == base
    assert _build.source_hash("nvcc release 12.8") != base
    monkeypatch.setattr(torch.version, "cuda", "11.8")
    cuda = _build.source_hash("nvcc release 12.4")
    assert cuda != base
    monkeypatch.setattr(platform, "machine", lambda: "aarch64-elsewhere")
    assert _build.source_hash("nvcc release 12.4") not in (base, cuda)
