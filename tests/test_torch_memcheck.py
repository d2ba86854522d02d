"""The memory check's harness and build on the CPU (tools/memcheck.py,
ops/_build.py's checked build, csrc/check.cuh's record).

The checks themselves run on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py's phase 3m); here: the guard bands, the sweep's cases and
their coverage of every launch plan, the checked build's flags, name and
stamp beside the default's, that nothing but the memcheck asks for the
checked library, the fault record's layout and message, and that the
Python tables name what the CUDA sources enumerate.
"""
import ast
import ctypes
import json
import platform
import re
import sys
from pathlib import Path

import pytest
import torch

from vsrcic_tpu_torch.ops import _build
from vsrcic_tpu_torch.ops import fused_attention as fa
from vsrcic_tpu_torch.ops import vocab_topk as vt
from vsrcic_tpu_torch.tools import memcheck as mc

PKG = Path(_build.PKG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where,hit", [("before", True), ("after", True),
                                       ("inside", False)])
def test_guarded_sees_a_write_past_the_view(where, hit, dtype):
    g = mc.guarded((3, 5), dtype, "cpu")
    assert g.view.shape == (3, 5) and g.view.is_contiguous()
    assert g.breaches() == 0
    size = g.view.element_size()
    assert g.lo % 256 == 0 and (g.hi - g.lo) == 15 * size
    # one element through the base storage, as the kernel would write it
    elems = g.base.view(dtype)
    first = g.lo // size
    elems[{"before": first - 1, "after": first + 15,
           "inside": first + 7}[where]] = 1.0
    assert (g.breaches() > 0) == hit
    assert (g.view.flatten()[7] == 1.0) == (where == "inside")


def test_guarded_misalign_and_margin():
    g = mc.guarded((7,), torch.float32, "cpu", margin=512, misalign=4)
    assert g.lo == 516 and g.base.numel() == 516 + 28 + 512
    assert g.view.data_ptr() - g.base.data_ptr() == 516
    with pytest.raises(ValueError):
        mc.guarded((7,), torch.float32, "cpu", margin=100)
    with pytest.raises(ValueError):
        mc.guarded((7,), torch.float32, "cpu", misalign=2)


@pytest.fixture(scope="module")
def cases():
    return mc.sweep_cases(0)


def test_sweep_is_deterministic(cases):
    assert mc.sweep_cases(0) == cases
    again = mc.sweep_cases(3)
    assert [c.name for c in again] == [c.name for c in cases]
    assert [c.seed for c in again] != [c.seed for c in cases]
    assert len({c.name for c in cases}) == len(cases)


def test_sweep_reaches_every_vocab_route(cases):
    """Every route vocab_launch_plan can return, each at full width (rows
    5121 at V 9999, 10000 and 10007; the beam's 5120 x FULL_REPEATS), rows
    1 and 127, R 8, 77 and 1000, V 1, 29, 30 and 129, k 1 and 5, a pitch
    greater than V and a non-finite table."""
    vocab = [c for c in cases if c.op == "vocab"]
    routes = set(vt.PLANES) | {"mma_sync", "sgemm"}
    assert {c.plan.route for c in vocab} == routes
    for route in routes:
        mine = [c for c in vocab if c.plan.route == route]
        assert {c.shape[2] for c in mine if c.shape[0] == 5121} == {
            9999, 10000, 10007}
        assert any(c.shape[:3] == (5120, 1000, 10000)
                   and c.repeats >= mc.FULL_REPEATS for c in mine)
        assert {c.shape[0] for c in mine} >= {1, 127}
        assert {c.shape[2] for c in mine} >= {1, 29, 30, 129}
        assert {c.shape[3] for c in mine} == {1, 5}
        assert any(c.layout == "pitch" for c in mine)
        assert any(not c.finite for c in mine)
    assert {c.shape[1] for c in vocab} >= {8, 77, 1000}
    # the planner's resident clusters forced on the TMA routes
    assert {c.plan.route for c in vocab if "resident" in c.name} == set(
        vt.PLANES)


def test_sweep_reaches_every_fused_plan(cases):
    """Every cluster of CLUSTERS in both copy modes, every batch of
    BATCHES, runs of 1 and MAX_RUN, FUSED_CASES on both tables and the
    out-of-range rows; the beam's call FULL_REPEATS times."""
    fused = [c for c in cases if c.op == "fused"]
    for c in fa.CLUSTERS:
        for bulk in (True, False):
            assert any(f.plan.cluster == c and f.plan.bulk == bulk
                       for f in fused), (c, bulk)
    assert {f.plan.batch for f in fused} >= set(fa.BATCHES)
    assert {f.plan.rows_per_run for f in fused} >= {1, fa.MAX_RUN}
    smoke = mc._smoke()
    for table in ("bfloat16", "float32"):
        assert len([f for f in fused if f.shape[6] == table
                    and not f.name.startswith(("plan_", "bad_"))]) == len(
                        smoke.FUSED_CASES)
        assert any(f.bad == smoke.FUSED_BAD_ROWS and f.shape[6] == table
                   for f in fused)
    beam = [f for f in fused if f.shape[:2] == (smoke.ROWS, smoke.BATCH)
            and f.shape[3] == smoke.M_PAD and f.shape[6] == "bfloat16"]
    assert any(f.repeats >= mc.FULL_REPEATS for f in beam)


def test_sweep_reaches_every_sinkhorn_case(cases):
    smoke = mc._smoke()
    assert sorted(c.shape for c in cases if c.op == "sinkhorn") == sorted(
        (s, n) for n in smoke.SINK_CASE_N for s in smoke.SINK_CASE_S)


def test_sweep_launches_every_kernel(cases):
    launched = {}
    for c in cases:
        for k, n in c.launches().items():
            launched[k] = launched.get(k, 0) + n
    assert set(launched) == set(mc.KERNELS)
    # --repeats 500 launches each kernel at least 10,000 times
    counts = {}
    for c in cases:
        for k, n in c.launches(max(500, c.repeats)).items():
            counts[k] = counts.get(k, 0) + n
    assert min(counts.values()) >= 10_000


@pytest.mark.parametrize("route,kernels", [
    ("split", {"vocab_split", "vocab_tma", "vocab_merge"}),
    ("split9", {"vocab_split", "vocab_tma", "vocab_merge"}),
    ("split_w", {"vocab_split", "vocab_tma", "vocab_merge"}),
    ("tma", {"vocab_tma", "vocab_merge"}),
    ("mma_sync", {"vocab_tile_bf16", "vocab_merge"}),
    ("sgemm", {"vocab_tile", "vocab_merge"})])
def test_vocab_case_launches_its_route(route, kernels):
    case = mc._vocab_case("c", 127, 1000, 129, 5, route,
                          "contiguous" if route in ("mma_sync", "sgemm")
                          else "padded")
    assert case.plan.route == route
    got = case.launches(3)
    assert set(got) == kernels
    # W_t's planes are made once a table; h2's on every launch
    assert got.get("vocab_split", 0) == (
        (3 if case.plan.planes > 1 else 0)
        + (1 if case.plan.w_planes > 1 else 0))


def test_vocab_buffers_follow_the_plan():
    """The partials are by tile on the SGEMM and mma.sync routes, by row
    on the TMA kernel, ceil(V / the plan's tile) of them; the allocator is
    the caller's."""
    seen = []

    def empty(shape, dtype, device):
        seen.append((tuple(shape), dtype))
        return torch.empty(shape, dtype=dtype, device=device)

    for route, lead in (("sgemm", (2, 127)), ("split", (127, 2)),
                        ("tma", (127, 1))):
        case = mc._vocab_case("c", 127, 1000, 129, 5, route,
                              "contiguous" if route == "sgemm" else "padded")
        seen.clear()
        outs, parts = vt.vocab_buffers(case.plan, 127, 129, 5, "cpu", empty)
        assert [s for s, _ in seen] == [(127, 5), (127, 5), (127, 1),
                                        lead + (5,), lead + (5,), lead, lead]
        f32, i32 = torch.float32, torch.int32
        assert [d for _, d in seen] == [f32, i32, f32, f32, i32, f32, f32]
        assert outs[1] is not None and len(parts) == 4


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An nvcc stand-in that records its command lines and writes its
    outputs, with BUILD in tmp_path (as tests/test_torch_build_stamp.py
    moves it)."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!%s\nimport json, sys\nargs = sys.argv[1:]\n"
        "if '--version' in args:\n    print('fake nvcc, release 0.0')\n"
        "    sys.exit(0)\n"
        "open(%r, 'a').write(json.dumps(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('built')\n"
        % (sys.executable, str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return log


def test_checked_build_has_its_flags_name_and_stamp(fake_nvcc):
    """The checked build compiles every source with the default flags and
    -DVSRCIC_CHECKED=1 -lineinfo into a library and stamp of its own; the
    default build keeps today's flags, name and stamp."""
    assert _build.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    assert _build.LIB_NAME == "libvsrcic_kernels.so"
    assert _build.CHECKED_FLAGS == _build.NVCC_FLAGS + [
        "-DVSRCIC_CHECKED=1", "-lineinfo"]
    default = _build.build()
    checked = _build.build(checked=True)
    assert default.name == "libvsrcic_kernels.so"
    assert checked.name == "libvsrcic_kernels_checked.so"
    assert default.parent == checked.parent == _build.BUILD
    calls = [json.loads(line) for line in fake_nvcc.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    sources = {str(s) for s in _build._sources()}
    n = len(sources)
    assert len(compiles) == 2 * n
    for cmd in compiles[:n]:
        assert cmd[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert "-DVSRCIC_CHECKED=1" not in cmd and "-lineinfo" not in cmd
    for cmd in compiles[n:]:
        assert cmd[:len(_build.CHECKED_FLAGS)] == _build.CHECKED_FLAGS
    assert {c[c.index("-c") + 1] for c in compiles} == sources
    # each stamp is its own build's digest; today's formula for the default
    ident = _build.compiler_identity(_build._nvcc())
    stamps = {p.name: p.read_text() for p in _build.BUILD.glob("*.sha")}
    parts = [platform.machine(), str(torch.version.cuda)]
    srcs = _build._sources() + sorted(_build.CSRC.glob("*.cuh"))
    assert stamps["libvsrcic_kernels.so.sha"] == _build._stamp(
        [" ".join(_build.NVCC_FLAGS), ident] + parts, srcs)
    assert stamps["libvsrcic_kernels_checked.so.sha"] == _build._stamp(
        [" ".join(_build.CHECKED_FLAGS), ident] + parts, srcs)
    assert len(set(stamps.values())) == 2
    # both are kept: neither build redoes the other
    before = len(calls)
    _build.build()
    _build.build(checked=True)
    assert len(fake_nvcc.read_text().splitlines()) == before


def _asks_for_checked(tree, bare=False):
    """Calls of _build.library(...) or _build.build(...) (`bare`: of
    library(...) or build(...), inside ops/_build.py) in `tree` whose
    `checked` may be true."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if bare:
            name = getattr(f, "id", None)
        elif isinstance(f, ast.Attribute) and getattr(
                f.value, "id", None) == "_build":
            name = f.attr
        else:
            continue
        if name not in ("library", "build"):
            continue
        args = node.args[:1] + [k.value for k in node.keywords
                                if k.arg == "checked"]
        if any(not (isinstance(a, ast.Constant) and not a.value)
               for a in args):
            yield node


def test_only_the_memcheck_asks_for_the_checked_library():
    """No module of the package but tools/memcheck.py builds or loads the
    checked library (ops/_build.py's own build passes its argument on); no
    environment variable selects it."""
    hits = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                  if any(_asks_for_checked(ast.parse(p.read_text()))))
    assert hits == ["tools/memcheck.py"]
    build_src = ast.parse((PKG / "ops" / "_build.py").read_text())
    assert [ast.unparse(n) for n in _asks_for_checked(build_src, True)] == [
        "build(checked)"]
    assert "environ" not in ast.unparse(build_src)
    assert "getenv" not in ast.unparse(build_src)


def test_fault_record_layout():
    """mc.Fault is csrc/check.cuh's VsrcicFault: 48 bytes, index at 32."""
    assert ctypes.sizeof(mc.Fault) == 48
    assert mc.Fault.index.offset == 32 and mc.Fault.bound.offset == 40
    src = (PKG / "csrc" / "check.cuh").read_text()
    body = re.search(r"struct VsrcicFault \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\b([a-z_]+)\b(?=[,;])", body)
    assert names == [f for f, _ in mc.Fault._fields_]


@pytest.mark.parametrize("rec,file,parts", [
    (dict(count=3, kernel=3, line=1234, block=17, thread=130, kind=0,
          bound_id=5, index=999, bound=999), "vocab_topk.cu",
     ["vocab_tma", "vocab_topk.cu:1234", "block 17", "thread 130",
      "global access", "index 999", "bound 999", "part_vals/part_ids",
      "3 faults"]),
    (dict(count=1, kernel=0, line=77, block=-1, thread=-1, kind=3,
          bound_id=30, index=40959, bound=40958), "fused_attention.cu",
     ["fused_attention", "fused_attention.cu:77", "on the host",
      "tensor-map extent", "index 40959", "bound 40958", "det map",
      "1 fault"]),
    (dict(count=2, kernel=6, line=9, block=0, thread=31, kind=1,
          bound_id=3, index=-1, bound=1320), "sinkhorn.cu",
     ["sinkhorn_packed", "sinkhorn.cu:9", "block 0", "thread 31",
      "shared access", "index -1", "warp tiles"])])
def test_a_fault_record_decodes(rec, file, parts):
    msg = mc.describe(mc.Fault(**rec), file)
    for part in parts:
        assert part in msg, (part, msg)


def test_tables_name_what_the_sources_enumerate():
    """KERNELS and KINDS follow check.cuh's enums, BOUNDS each file's
    Bound enum, FILES check.cu's order."""
    csrc = PKG / "csrc"

    def enum(text, name):
        body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
        return {int(v): k for k, v in re.findall(r"(k\w+) = (\d+)", body)}

    check = (csrc / "check.cuh").read_text()
    kernels = enum(check, "VsrcicKernel")
    assert list(kernels) == list(range(len(mc.KERNELS)))
    assert len(enum(check, "VsrcicAccess")) == len(mc.KINDS)
    for kernel, file in (("fused_attention", "fused_attention.cu"),
                         ("vocab_tma", "vocab_topk.cu"),
                         ("sinkhorn_block", "sinkhorn.cu")):
        bounds = enum((csrc / file).read_text(), "Bound")
        assert set(bounds) == set(mc.BOUNDS[kernel]), file
    files = re.search(r"files\[kFiles\].*?\};",
                      (csrc / "check.cu").read_text(), re.S).group(0)
    assert re.findall(r"vsrcic_check_(\w+)", files) == [
        "fused", "vocab", "sinkhorn"]
    assert mc.FILES == ("fused_attention.cu", "vocab_topk.cu", "sinkhorn.cu")
