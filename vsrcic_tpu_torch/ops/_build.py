"""Build and load the port's CUDA kernels and its host libraries.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with `ctypes`. A host library (`csrc/<stem>.cpp`,
the CIDEr-D scorer) is compiled by the host C++ compiler alone
(`host_library`), so that it builds where there is no CUDA toolkit too.
Each build runs at first use, from the sources in the checkout, into
`vsrcic_tpu_torch/build/` (listed in `.gitignore`), and is redone when its
stamp changes. The stamp hashes the sources, the flags, the compiler's
`--version` output and `platform.machine()`, and for the CUDA library also
`torch.version.cuda`: a `build/` made on another machine or by another
compiler is rebuilt, never loaded. A failed build raises. Libraries and
stamps are written into temporary files and moved into place, so that
processes building at once (the ranks of a data-parallel run) never read
half of either.

`library(checked=True)` builds the same sources with `CHECKED_FLAGS`
(`-DVSRCIC_CHECKED=1 -lineinfo`: every access of every kernel tested
against its bound, csrc/check.cuh) into `CHECKED_LIB_NAME`, under a stamp
of its own, at first use. Only the memory check asks for it
(`tools/memcheck.py`, chip_smoke.py's memcheck phase, the card tests); the
main path loads the default library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIB_NAME = "libvsrcic_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CHECKED_LIB_NAME = "libvsrcic_kernels_checked.so"
CHECKED_FLAGS = NVCC_FLAGS + ["-DVSRCIC_CHECKED=1", "-lineinfo"]
CXX = "c++"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C entry points: name -> argtypes; each returns cudaGetLastError()
SIGNATURES = {
    "vsrcic_fused_attention": [P, P, P, P, P, P, P, P, P, I,
                               I, I, I, I, I, I, I, I, I, I, I, I, I,
                               I, I, P, P, P],
    "vsrcic_vocab_topk": [P, P, P, I, I, I, I, I, I,
                          P, P, P, P, P, P, P, P],
    "vsrcic_vocab_topk_bf16": [P, P, P, I, I, I, I, I, I, I, I, I, I, I, I,
                               I, P, P, P, P, P, P, P, P],
    "vsrcic_vocab_split": [P, I, I, P, P],
    "vsrcic_vocab_tma_clusters": [I, I, I, P],
    "vsrcic_sinkhorn": [P, I, I, I, F, F, P, P],
}
# the checked build's records (csrc/check.cu)
CHECK_SIGNATURES = {
    "vsrcic_check_read": [P],
    "vsrcic_check_reset": [],
    "vsrcic_check_cut": [I, I],
}

# seconds the last default build took in this process (0.0 when it was
# cached) and what nvcc said; the same of the checked build
last_build_seconds = 0.0
last_build_log = ""
last_checked_build_seconds = 0.0
last_checked_build_log = ""
last_host_build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    return srcs


def compiler_identity(compiler: str) -> str:
    """The whole `--version` output of `compiler` (nvcc's first line is the
    same for every release; its release is on a later one). Raises if the
    compiler does not run."""
    try:
        res = subprocess.run([compiler, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError("%s does not run: %s" % (compiler, e)) from e
    if res.returncode:
        raise RuntimeError("%s --version failed (%d): %s"
                           % (compiler, res.returncode, res.stdout))
    return res.stdout.strip()


def _stamp(parts, sources) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part.encode() + b"\0")
    for src in sources:
        h.update(src.name.encode() + b"\0")
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _flavour(checked):
    """(library name, nvcc flags) of the default or the checked build."""
    return ((CHECKED_LIB_NAME, CHECKED_FLAGS) if checked
            else (LIB_NAME, NVCC_FLAGS))


def source_hash(compiler: str, checked: bool = False) -> str:
    """The CUDA library's stamp, given `compiler_identity(nvcc)`: the
    sources and the headers they include (`csrc/*.cuh`), under the flags
    of the default or the checked build."""
    import torch
    return _stamp([" ".join(_flavour(checked)[1]), compiler,
                   platform.machine(), str(torch.version.cuda)],
                  _sources() + sorted(CSRC.glob("*.cuh")))


def write_stamp(stamp: Path, digest: str) -> None:
    """Write a stamp as the libraries are written: into a temporary file
    beside it, then `os.replace`, so that a process reading it (another
    rank building at the same time) sees the old stamp or the new one,
    never half of one."""
    fd, tmp = tempfile.mkstemp(dir=stamp.parent, prefix=stamp.name + ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(digest)
        os.replace(tmp, stamp)
    except BaseException:
        os.unlink(tmp)
        raise


def build(checked: bool = False) -> Path:
    """Compile and link the library (the default build, or the checked
    one) unless a build of these sources exists; returns its path."""
    global last_build_seconds, last_build_log
    global last_checked_build_seconds, last_checked_build_log
    nvcc = _nvcc()
    name, flags = _flavour(checked)
    digest = source_hash(compiler_identity(nvcc), checked)
    lib = BUILD / name
    stamp = BUILD / (name + ".sha")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        if checked:
            last_checked_build_seconds = 0.0
        else:
            last_build_seconds = 0.0
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode:
                raise RuntimeError("nvcc failed (%d): %s\n%s"
                                   % (p.returncode, " ".join(cmd), out))
        tmp_lib = Path(tmp) / name
        cmd = [nvcc, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError("nvcc link failed (%d): %s\n%s"
                               % (res.returncode, " ".join(cmd), res.stdout))
        os.replace(tmp_lib, lib)
    write_stamp(stamp, digest)
    if checked:
        last_checked_build_seconds = time.perf_counter() - t0
        last_checked_build_log = "".join(logs)
    else:
        last_build_seconds = time.perf_counter() - t0
        last_build_log = "".join(logs)
    return lib


def host_library(stem: str) -> Path:
    """Compile `csrc/<stem>.cpp` with the host C++ compiler (`CXX`) into
    `build/lib<stem>.so` unless a build of this source with these flags, by
    this compiler on this kind of machine, exists; returns its path.
    Concurrent builders each compile into their own temporary directory and
    move the result into place."""
    global last_host_build_seconds
    src = CSRC / (stem + ".cpp")
    digest = _stamp([" ".join(CXX_FLAGS), compiler_identity(CXX),
                     platform.machine()], [src])
    lib = BUILD / ("lib%s.so" % stem)
    stamp = BUILD / (lib.name + ".sha")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        last_host_build_seconds = 0.0
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        out = Path(tmp) / lib.name
        cmd = [CXX, *CXX_FLAGS, "-o", str(out), str(src)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError("c++ failed (%d): %s\n%s"
                               % (res.returncode, " ".join(cmd), res.stdout))
        os.replace(out, lib)
    write_stamp(stamp, digest)
    last_host_build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def library(checked: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built first if needed): the default
    build, or the checked one, which also has CHECK_SIGNATURES."""
    lib = ctypes.CDLL(str(build(checked)))
    for name, argtypes in (SIGNATURES | (CHECK_SIGNATURES if checked
                                         else {})).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vsrcic_error_string.argtypes = [ctypes.c_int]
    lib.vsrcic_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (launch plans)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, name: str, lib=None) -> None:
    """Raise on a refused or failed launch (cudaGetLastError() != 0) of
    `lib` (default: the default library)."""
    if err:
        msg = (lib or library()).vsrcic_error_string(err).decode()
        raise RuntimeError("%s: CUDA launch failed: error %d (%s)"
                           % (name, err, msg))


def check_tensor(t, name, shape, dtype, device) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of `shape`
    on `device` (what a kernel's pointer arithmetic assumes)."""
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            "%s is %s %s %s (contiguous=%s); the kernel needs %s %s %s "
            "contiguous" % (name, t.device, t.dtype, tuple(t.shape),
                            t.is_contiguous(), device, dtype, tuple(shape)))
