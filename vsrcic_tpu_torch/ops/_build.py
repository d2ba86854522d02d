"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with `ctypes`. The build runs at first use, from
the sources in the checkout, into `vsrcic_tpu_torch/build/` (listed in
`.gitignore`), and is redone when the hash of the sources or flags changes.
A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C entry points: name -> argtypes; each returns cudaGetLastError()
SIGNATURES = {
    "vsrcic_fused_attention": [P, P, P, P, P, P, P, P, P, I,
                               I, I, I, I, I, I, P, P, P],
    "vsrcic_vocab_topk": [P, P, P, I, I, I, I, I, P, P, P, P, P, P, P, P],
    "vsrcic_sinkhorn": [P, I, I, I, F, F, P, P],
}

# seconds the last build took in this process (0.0 when it was cached)
last_build_seconds = 0.0
last_build_log = ""


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


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless a build of these sources exists;
    returns its path."""
    global last_build_seconds, last_build_log
    digest = source_hash()
    lib = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        last_build_seconds = 0.0
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
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
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [nvcc, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError("nvcc link failed (%d): %s\n%s"
                               % (res.returncode, " ".join(cmd), res.stdout))
        os.replace(tmp_lib, lib)
    stamp.write_text(digest)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "".join(logs)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vsrcic_error_string.argtypes = [ctypes.c_int]
    lib.vsrcic_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise on a refused or failed launch (cudaGetLastError() != 0)."""
    if err:
        msg = library().vsrcic_error_string(err).decode()
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
