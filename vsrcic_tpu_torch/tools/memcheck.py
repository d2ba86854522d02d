"""The port's memory check on the card, written by hand (compute-sanitizer
does not run on the card's machine).

    python -m vsrcic_tpu_torch.tools.memcheck [--repeats N] [--seed S]
        [--every K] [--old-fused DIR]

Two nets, over every launch plan the code can pick:

  * the checked build (`_build.library(checked=True)`, csrc/check.cuh):
    every access of every kernel is tested against the bound its own
    arguments imply; a fault is counted, the first one recorded (kernel,
    source line, block, thread, kind, index, bound) and the access dropped;
  * guarded buffers: every input is copied into, and every output and
    workspace made in, a view in the middle of a larger buffer whose
    margins hold GUARD (`guarded`); after the launches the margins must be
    intact (what the bounds cannot see: arguments that do not match the
    real allocations), and every input equal to its copy byte for byte.
    GUARD bytes read as a float are NaN and as an index -1 (out of range),
    and an output starts as GUARD bytes, so a read past an input or an
    output left unwritten shows in the comparison with the plain version.

`sweep_cases(seed)` lists the cases: the fused kernel on chip_smoke.py's
FUSED_CASES and FUSED_BAD_ROWS on bf16 and f32 tables, and under plans
forced through `ops/fused_attention.py::_plan` (every cluster of CLUSTERS
and one CTA, every batch of BATCHES, runs of 1 and MAX_RUN, TMA boxes and
element copies); the vocab head on every route of `vocab_launch_plan`
("split", "split9", "split_w", "tma", "mma_sync", "sgemm") at rows 1, 127
and 5121, R 8, 77 and 1000, V 1, 29, 30, 129, 9999, 10000 and 10007, k 1
and 5, a pitch greater than V, an unaligned table, a non-finite table and
forced resident clusters; the Sinkhorn kernel at every (n, S) of
SINK_CASE_N x SINK_CASE_S. The beam's fused call and each route's
full-width call run FULL_REPEATS times. `run_case(case, lib)` launches a
case and returns what it found: the fault records, guard breaches,
changed inputs, and whether the outputs match the plain version at
chip_smoke.py phase 3's tolerances. chip_smoke.py runs the sweep in its
memcheck phase; this tool runs it with `--repeats N` launches of every
case (a longer hunt for a rare fault) and prints one line per kernel and
a JSON summary (also `chiprun_out/memcheck.json`) beside the card's name
and power limit. `--old-fused DIR` runs another checkout's fused kernel
instead, in its first design (no thread-block clusters and no launch
plan: `git archive 1c0190f`, the last tree with it), on the sweep's fused
cases under the guard bands alone (that build has no checks).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# csrc/check.cuh's VsrcicKernel and VsrcicAccess, in order
KERNELS = ("fused_attention", "vocab_tile", "vocab_tile_bf16", "vocab_tma",
           "vocab_split", "vocab_merge", "sinkhorn_packed", "sinkhorn_block")
KINDS = ("global", "shared", "distributed shared", "tensor-map extent",
         "mbarrier")
# the files whose records vsrcic_check_read returns, in order
FILES = ("fused_attention.cu", "vocab_topk.cu", "sinkhorn.cu")
# each file's Bound enum (the csrc sources say what each bounds)
_FUSED_BOUNDS = {
    1: "item/ctrl", 2: "ha", 3: "sent_w/sent_mask", 4: "fc_sentinel",
    5: "att_a", 6: "det", 7: "proj", 8: "out", 9: "gate evidence",
    10: "group rows", 11: "layout total", 12: "det slices",
    13: "proj slices", 14: "ha slices", 15: "sentinel scalars",
    16: "att_a slice", 17: "partial det_w", 18: "partial row sums",
    19: "weights", 20: "mask", 21: "sentinel weights", 22: "window keys",
    23: "segment keys", 24: "valid rows", 25: "segments' first rows",
    26: "scan scratch", 27: "window region", 28: "mbarrier",
    29: "cluster rank", 30: "det map", 31: "proj map"}
_VOCAB_BOUNDS = {
    1: "h2", 2: "W_t", 3: "bias", 4: "part_m/part_s",
    5: "part_vals/part_ids", 6: "vals/ids", 7: "lse", 8: "planes",
    9: "h2 slices", 10: "W_t slices", 11: "f32 tile",
    12: "dynamic shared bytes", 13: "ring slot", 14: "box or operand",
    15: "cluster rank", 16: "h2 map", 17: "W_t map"}
_SINKHORN_BOUNDS = {1: "x", 2: "out", 3: "warp tiles", 4: "matrix",
                    5: "dynamic shared bytes"}
BOUNDS = dict(zip(KERNELS, (_FUSED_BOUNDS,) + (_VOCAB_BOUNDS,) * 5
                  + (_SINKHORN_BOUNDS,) * 2))

GUARD = 0xFF            # every byte of a guard band (NaN, -1)
MARGIN = 4096           # guard bytes on each side of a view
FULL_REPEATS = 200      # launches of the beam's fused call, each full route
SINK_ITERS, SINK_TAU = 20, 0.1
VOCAB_ROUTES = ("split", "split9", "split_w", "tma", "mma_sync", "sgemm")
# the routes' operand types: (h2, table)
_TYPES = {"split": ("float32", "bfloat16"), "split9": ("float32", "float32"),
          "split_w": ("bfloat16", "float32"),
          "tma": ("bfloat16", "bfloat16"),
          "mma_sync": ("bfloat16", "bfloat16"),
          "sgemm": ("float32", "bfloat16")}
# the CUDA kernels each vocab route launches (beside the merge)
_ROUTE_KERNELS = {"split": ("vocab_split", "vocab_tma"),
                  "split9": ("vocab_split", "vocab_tma"),
                  "split_w": ("vocab_tma",), "tma": ("vocab_tma",),
                  "mma_sync": ("vocab_tile_bf16",), "sgemm": ("vocab_tile",)}


class Fault(ctypes.Structure):
    """csrc/check.cuh's VsrcicFault."""
    _fields_ = [("count", ctypes.c_ulonglong), ("kernel", ctypes.c_int),
                ("line", ctypes.c_int), ("block", ctypes.c_int),
                ("thread", ctypes.c_int), ("kind", ctypes.c_int),
                ("bound_id", ctypes.c_int), ("index", ctypes.c_longlong),
                ("bound", ctypes.c_longlong)]


def describe(rec, file):
    """One line that names a record's first fault: kernel, file and line,
    block and thread (the host: a tensor map's extent, checked as it is
    encoded), kind of access, bound, index, and the count of faults."""
    kernel = KERNELS[rec.kernel] if 0 <= rec.kernel < len(KERNELS) else (
        "kernel %d" % rec.kernel)
    where = ("on the host" if rec.block < 0 else
             "block %d, thread %d" % (rec.block, rec.thread))
    kind = KINDS[rec.kind] if 0 <= rec.kind < len(KINDS) else (
        "kind %d" % rec.kind)
    bound = BOUNDS.get(kernel, {}).get(rec.bound_id, "bound %d"
                                       % rec.bound_id)
    return ("%s (%s:%d), %s: %s access at index %d of bound %d (%s); %d "
            "fault%s" % (kernel, file, rec.line, where, kind, rec.index,
                         rec.bound, bound, rec.count,
                         "" if rec.count == 1 else "s"))


def faults(lib):
    """The checked library's non-empty records, [(file, Fault)], after the
    card has finished every launch."""
    import torch
    torch.cuda.synchronize()
    recs = (Fault * (2 * len(FILES)))()
    err = lib.vsrcic_check_read(ctypes.addressof(recs))
    if err:
        raise RuntimeError("vsrcic_check_read: CUDA error %d" % err)
    return [(FILES[i // 2], recs[i]) for i in range(len(recs))
            if recs[i].count]


def reset(lib):
    import torch
    torch.cuda.synchronize()
    err = lib.vsrcic_check_reset()
    if err:
        raise RuntimeError("vsrcic_check_reset: CUDA error %d" % err)


def cut(lib, kernel=-1, bound=-1):
    """Bound `bound` of kernel `kernel` (a KERNELS index) one element short
    from the next launch on; no argument restores every bound."""
    import torch
    torch.cuda.synchronize()
    err = lib.vsrcic_check_cut(kernel, bound)
    if err:
        raise RuntimeError("vsrcic_check_cut: CUDA error %d" % err)


class Guard:
    """A view of `shape` in the middle of a uint8 buffer whose `margin`
    bytes on each side hold GUARD (`guarded`)."""

    def __init__(self, shape, dtype, device, margin, misalign):
        import torch
        size = torch.empty((), dtype=dtype).element_size()
        if margin % 256 or misalign % size:
            raise ValueError("guarded: margin %d is not a multiple of 256, "
                             "or misalign %d of the element size"
                             % (margin, misalign))
        nbytes = math.prod(shape) * size
        self.lo = margin + misalign
        self.hi = self.lo + nbytes
        self.base = torch.full((self.hi + margin,), GUARD, dtype=torch.uint8,
                               device=device)
        self.view = self.base[self.lo:self.hi].view(dtype).view(shape)

    def breaches(self):
        """Guard bytes that no longer hold GUARD (0: the margins are
        intact)."""
        return int((self.base[:self.lo] != GUARD).sum()
                   + (self.base[self.hi:] != GUARD).sum())

    def inner(self):
        """The view's bytes (what a bytewise comparison reads)."""
        return self.base[self.lo:self.hi]


def guarded(shape, dtype, device, margin=MARGIN, misalign=0):
    """A `Guard`: `.view` is a contiguous tensor of `shape` and `dtype`,
    `misalign` bytes past a 256-byte boundary, between two guard bands of
    `margin` bytes; `.breaches()` counts the guard bytes changed since."""
    return Guard(tuple(shape), dtype, device, margin, misalign)


@dataclasses.dataclass(frozen=True)
class Case:
    """One launch of the sweep. op "fused": shape (rows, B, L, M, D, A,
    table, n_real, beam, ctrl_by), `bad` rows out of range; op "vocab":
    shape (rows, R, V, k, h2 dtype, table dtype), `layout` ("padded":
    rows V rounded up to 8 apart, "pitch": 8 more, "contiguous",
    "unaligned": contiguous, the base one element off), `finite`; op
    "sinkhorn": shape (S, n). `plan` is the launch plan; `repeats` the
    launches."""
    op: str
    name: str
    shape: tuple
    plan: object = None
    bad: tuple = ()
    layout: str = "padded"
    finite: bool = True
    repeats: int = 1
    seed: int = 0

    def launches(self, repeats=None):
        """{kernel: launches} of running the case `repeats` times (default
        its own)."""
        n = self.repeats if repeats is None else repeats
        if self.op == "fused":
            return {"fused_attention": n}
        if self.op == "sinkhorn":
            return {("sinkhorn_packed" if self.shape[1] <= 32
                     else "sinkhorn_block"): n}
        out = {k: n for k in _ROUTE_KERNELS[self.plan.route]}
        if self.plan.w_planes > 1:   # W_t's planes, made once a table
            out["vocab_split"] = out.get("vocab_split", 0) + 1
        out["vocab_merge"] = n
        return out


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py of this checkout, as a module (its case lists,
    shapes and input makers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fused_cases(smoke, sms, seed):
    from vsrcic_tpu_torch.ops import fused_attention as fa
    cases = []
    tables = (("bfloat16", 2), ("float32", 4))
    for (name, rows, b, m, d, a, n_real, beam, l, ctrl_by) in \
            smoke.FUSED_CASES:
        for table, tb in tables:
            full = (name == "full" and rows == smoke.ROWS
                    and m == smoke.M_PAD and tb == 2)
            cases.append(Case(
                "fused", "%s_rows%d_M%d_D%d_%s" % (name, rows, m, d, table),
                (rows, b, l, m, d, a, table, n_real, beam, ctrl_by),
                fa.fused_launch_plan(rows, m, d, a, tb, True, sms),
                repeats=FULL_REPEATS if full else 1, seed=seed + len(cases)))
    for table, tb in tables:
        for rows, b, m, d, a in ((37, 8, smoke.M_PAD, smoke.DET, smoke.ATT),
                                 (37, 8, 5, 100, 36)):
            cases.append(Case(
                "fused", "bad_M%d_D%d_%s" % (m, d, table),
                (rows, b, smoke.L_GROUPS, m, d, a, table, m, smoke.BEAM,
                 "item"),
                fa.fused_launch_plan(rows, m, d, a, tb, True, sms),
                bad=smoke.FUSED_BAD_ROWS, seed=seed + len(cases)))
    # forced plans: runs cross cluster and grid boundaries (613 rows of
    # beam 5 on groups shared by an item's beams)
    rows, b, m, d, a = 613, 123, smoke.M_REGIONS, smoke.DET, smoke.ATT
    for table, tb in tables:
        for c in (1,) + fa.CLUSTERS:
            for p in fa.BATCHES:
                for run in (1, fa.MAX_RUN):
                    for aligned in (True, False):
                        try:
                            plan = fa._plan(rows, m, d, a, tb, aligned, sms,
                                            cluster=c, batch=p, run=run)
                        except ValueError:
                            continue   # the group does not fit C CTAs
                        cases.append(Case(
                            "fused", "plan_c%d_p%d_run%d_%s_%s"
                            % (c, p, run, "bulk" if plan.bulk else "elem",
                               table),
                            (rows, b, smoke.L_GROUPS, m, d, a, table, m,
                             smoke.BEAM, "item"), plan,
                            seed=seed + len(cases)))
    return cases


def _vocab_case(name, rows, r, v, k, route, layout="padded", finite=True,
                sms=132, resident=None, aligned=True, table=None,
                repeats=1, seed=0):
    """A vocab case forced onto `route`: its operand types, W_t's layout
    (its row pitch), and the planner's own arguments: `aligned` and
    `resident` as given, `ldw` from the layout, and `finite_table=False`
    on "sgemm" (the facade's route for a non-finite table, which takes an
    f32 h2 there on any layout)."""
    import torch
    from vsrcic_tpu_torch.ops.vocab_topk import vocab_launch_plan
    h2_dt, table_dt = _TYPES[route]
    table_dt = table or table_dt
    v8 = v + -v % 8
    pitch = {"padded": v8, "pitch": v8 + 8}.get(layout, v)
    ldw = pitch if r > 1 else v8
    if layout == "unaligned":
        aligned = False
    plan = vocab_launch_plan(rows, r, v, k, getattr(torch, h2_dt),
                             getattr(torch, table_dt), aligned, sms,
                             resident, ldw, route != "sgemm")
    if plan.route != route:
        raise AssertionError("vocab case %s: the planner took %s, not %s"
                             % (name, plan.route, route))
    return Case("vocab", name, (rows, r, v, k, h2_dt, table_dt), plan,
                layout=layout, finite=finite, repeats=repeats, seed=seed)


def _vocab_cases(sms, seed):
    cases = []

    def add(*a, **kw):
        cases.append(_vocab_case(*a, sms=sms, seed=seed + len(cases), **kw))

    for route in VOCAB_ROUTES:
        tma_one = route in ("tma", "split_w")   # R a multiple of 8
        natural = route in ("mma_sync", "sgemm")
        for rows in (1, 127):
            for r in (8, 77, 1000):
                if tma_one and r % 8:
                    continue
                for v in (1, 29, 30, 129):
                    for k in (1, 5):
                        if k > v:
                            continue
                        # mma.sync and the SGEMM where TMA cannot read W_t
                        # (a contiguous table of V no multiple of 8, or R
                        # not one for mma.sync), else by the planner's own
                        # `aligned`
                        layout, aligned = "padded", True
                        if natural and (v % 8 or (route == "mma_sync"
                                                  and r % 8)):
                            layout = "contiguous"
                        elif route == "mma_sync":
                            aligned = False
                        add("%s_r%d_R%d_V%d_k%d" % (route, rows, r, v, k),
                            rows, r, v, k, route, layout, aligned=aligned)
        full_layout = "contiguous" if route == "mma_sync" else "padded"
        for v in (9999, 10000, 10007):
            layout = ("contiguous" if natural and v % 8 else full_layout)
            add("%s_full_V%d" % (route, v), 5121, 1000, v, 5, route,
                layout, aligned=route != "mma_sync" or v % 8 != 0)
        add("%s_beam" % route, 5120, 1000, 10000, 5, route, full_layout,
            aligned=route != "mma_sync", repeats=FULL_REPEATS)
        add("%s_pitch" % route, 127, 8 if tma_one else 77, 129, 5, route,
            "pitch", aligned=route != "mma_sync")
        add("%s_nonfinite" % route, 127, 1000, 129, 5, route,
            "contiguous" if natural else "padded", finite=False)
        if natural:
            add("%s_unaligned" % route, 127, 77, 130, 5, route,
                "unaligned")
            if route == "sgemm":
                add("sgemm_f32_table", 127, 77, 129, 5, route, "contiguous",
                    table="float32")
        else:
            for resident in (1, 7):
                add("%s_resident%d" % (route, resident), 1000,
                    8 if tma_one else 1000, 1000, 5, route,
                    resident=resident)
    return cases


def sweep_cases(seed=0, sms=132):
    """The sweep, a deterministic list of Cases for a card of `sms` SMs
    (the module's note says what it covers)."""
    smoke = _smoke()
    cases = _fused_cases(smoke, sms, seed) + _vocab_cases(sms, seed + 1000)
    for n in smoke.SINK_CASE_N:
        for s in smoke.SINK_CASE_S:
            cases.append(Case("sinkhorn", "sinkhorn_n%d_S%d" % (n, s),
                              (s, n), seed=seed + 2000 + len(cases)))
    return cases


def cut_cases(sms=132):
    """The card tests' proof that the checks are live: {(kernel, bound id):
    (case, kind)}, one bound of each of the eight kernels (and the two
    tensor maps' extents) whose last element the case's launch reaches;
    cut by one element (`run_case(..., cut_bound=)`), it must fault there,
    with that kind."""
    from vsrcic_tpu_torch.ops import fused_attention as fa
    smoke = _smoke()
    rows, b, m, d, a = 37, 8, smoke.M_PAD, smoke.DET, smoke.ATT
    fused = Case("fused", "cut_fused",
                 (rows, b, smoke.L_GROUPS, m, d, a, "bfloat16",
                  smoke.M_REGIONS, smoke.BEAM, "item"),
                 fa.fused_launch_plan(rows, m, d, a, 2, True, sms))
    split = _vocab_case("cut_split", 127, 77, 129, 5, "split", sms=sms)
    return {
        ("fused_attention", 8): (fused, "global"),        # out
        ("fused_attention", 30): (fused, "tensor-map extent"),  # det map
        ("vocab_tile", 1): (_vocab_case(
            "cut_sgemm", 127, 77, 129, 5, "sgemm", "contiguous", sms=sms),
            "global"),                                     # h2
        ("vocab_tile_bf16", 2): (_vocab_case(
            "cut_mma", 127, 77, 129, 5, "mma_sync", "contiguous", sms=sms),
            "global"),                                     # W_t
        ("vocab_tma", 5): (split, "global"),               # part_vals/ids
        ("vocab_tma", 17): (_vocab_case(
            "cut_tma", 127, 1000, 129, 5, "tma", sms=sms),
            "tensor-map extent"),                          # W_t map
        ("vocab_split", 8): (split, "global"),             # planes
        ("vocab_merge", 7): (split, "global"),             # lse
        ("sinkhorn_packed", 2): (Case("sinkhorn", "cut_packed", (37, 10)),
                                 "global"),                # out
        ("sinkhorn_block", 1): (Case("sinkhorn", "cut_block", (7, 33)),
                                "global"),                 # x
    }


# ---------------------------------------------------------------------------
# one case on the card
# ---------------------------------------------------------------------------

class _Pool:
    """The guarded buffers of one case: inputs copied in (their bytes kept
    to compare after the launches), outputs made empty."""

    def __init__(self, device):
        self.device = device
        self.guards = []
        self.inputs = []   # (name, guard, bytes before)

    def input(self, name, t, misalign=0, pitch=None):
        """A guarded copy of `t`; for 2-D `t` with `pitch`, the copy's rows
        lie `pitch` elements apart (zeros between), as a [:, :V] view."""
        shape = tuple(t.shape) if pitch is None else (t.shape[0], pitch)
        g = guarded(shape, t.dtype, self.device, misalign=misalign)
        g.view.zero_()
        view = g.view if pitch is None else g.view[:, :t.shape[1]]
        view.copy_(t)
        self.guards.append(g)
        self.inputs.append((name, g, g.inner().clone()))
        return view

    def empty(self, shape, dtype, device=None):
        g = guarded(shape, dtype, self.device)
        self.guards.append(g)
        return g.view

    def breaches(self):
        return sum(g.breaches() for g in self.guards)

    def changed(self):
        import torch
        return [n for n, g, before in self.inputs
                if not torch.equal(g.inner(), before)]


def _run_fused(case, lib, pool, gen, repeats, launch=None):
    import torch
    from vsrcic_tpu_torch.ops import fused_attention as fa
    launch = launch or fa._launch
    smoke = _smoke()
    rows, b, l, m, d, a, table, n_real, beam, ctrl_by = case.shape
    args = smoke.fused_inputs(gen, rows, b, m, d, a, getattr(torch, table),
                              n_real, beam, l, ctrl_by)
    ok = torch.ones(rows, dtype=torch.bool, device=pool.device)
    run_args = list(args)
    if case.bad:
        bad = torch.tensor(case.bad, device=pool.device)
        run_args[0], run_args[1] = args[0].clone(), args[1].clone()
        run_args[0][bad[0::3]] = b
        run_args[1][bad[1::3]] = l
        run_args[0][bad[2::3]] = -1
        ok[bad] = False
    names = ("item", "ctrl", "ha", "sent_w", "sent_mask", "fc_sentinel",
             "att_a", "det", "proj")
    g_args = [pool.input(n, t) for n, t in zip(names, run_args)]
    out = pool.empty((rows, d), torch.float32)
    gsum = pool.empty((rows, 1), torch.float32)
    for _ in range(repeats):
        launch(lib, case.plan, *g_args, out, gsum)
    torch.cuda.synchronize()
    want = fa.fused_group_attention_plain(*args)
    got = (out, gsum)
    if case.bad and not all(bool(torch.isnan(g[~ok]).all()) for g in got):
        return None, "an out-of-range row is not NaN"
    err = max(float((g[ok] - w[ok]).abs().max()) for g, w in zip(got, want))
    if not all(torch.allclose(g[ok], w[ok], rtol=1e-5, atol=1e-5)
               for g, w in zip(got, want)):
        return err, "beyond rtol / atol 1e-5 of the plain version"
    return err, None


def _run_vocab(case, lib, pool, gen, repeats, launch=None):
    import torch
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    rows, r, v, k, h2_dt, table_dt = case.shape
    plan = case.plan
    dev = pool.device
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device=dev))
    h2 = h2.to(getattr(torch, h2_dt))
    w = torch.randn((r, v), generator=gen, device=dev) * (
        2.0 / (r + v)) ** 0.5
    if not case.finite:
        w[r // 2, v // 3] = -math.inf
    w = w.to(getattr(torch, table_dt))
    bias = 0.01 * torch.randn((v,), generator=gen, device=dev)
    if plan.route in ("sgemm", "split9") and h2.dtype == torch.bfloat16:
        h2 = h2.float()   # as the wrapper upcasts it
    v8 = v + -v % 8
    pitch = {"padded": v8, "pitch": v8 + 8}.get(case.layout)
    misalign = w.element_size() if case.layout == "unaligned" else 0
    g_h2 = pool.input("h2", h2)
    g_w = pool.input("w_t", w, misalign=misalign, pitch=pitch)
    g_b = pool.input("bias", bias)
    w_planes = h2_planes = None
    checks = []   # (name, got, want) of the split passes, bit for bit
    if plan.w_planes > 1:   # W_t's planes, once a table (table_planes)
        w_planes = pool.empty((vt.SPLIT_PLANES, r, v8), torch.bfloat16)
        vt._split_launch(lib, pool.input("w_t rows", w), w_planes)
        checks.append(("W_t planes", w_planes, vt.split_bf16x3_plain(w)))
    if plan.planes > 1:
        h2_planes = pool.empty((vt.SPLIT_PLANES, rows, r + -r % 8),
                               torch.bfloat16)
    outs, parts = vt.vocab_buffers(plan, rows, v, k, dev, pool.empty)
    for _ in range(repeats):
        if plan.planes > 1:
            vt._split_launch(lib, g_h2, h2_planes)
        vt._launch(lib, plan, g_h2, g_w, g_b, k, w_planes, h2_planes, parts,
                   outs)
    torch.cuda.synchronize()
    if plan.planes > 1:
        checks.append(("h2 planes", h2_planes, vt.split_bf16x3_plain(h2)))
    for name, got, want in checks:
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            return None, "the split pass's %s differ from " \
                         "split_bf16x3_plain" % name
    if not case.finite and plan.route in vt.PLANES:
        want = vt.vocab_planes_plain(h2, w, bias, k)
    else:
        want = vt.vocab_topk_lse_plain(h2, w, bias, k)
    err = 0.0
    for g, wnt, name in ((outs[0], want[0], "vals"), (outs[2], want[2],
                                                     "lse")):
        fin = torch.isfinite(wnt)
        if not torch.equal(fin, torch.isfinite(g)) or not torch.equal(
                torch.isnan(wnt), torch.isnan(g)) or not torch.equal(
                g[~fin & ~torch.isnan(g)], wnt[~fin & ~torch.isnan(wnt)]):
            return None, "%s: non-finite entries differ" % name
        if fin.any():
            err = max(err, float((g[fin] - wnt[fin]).abs().max()))
        if not torch.allclose(g[fin], wnt[fin], rtol=1e-5, atol=1e-6):
            return err, "%s beyond rtol 1e-5 / atol 1e-6" % name
    if not bool(((outs[1] >= 0) & (outs[1] < v)).all()):
        return err, "an id outside [0, V)"
    finite_rows = torch.isfinite(want[0]).all(1) & torch.isfinite(
        want[2][:, 0])
    got_f = (outs[0][finite_rows], outs[1][finite_rows])
    want_f = (want[0][finite_rows], want[1][finite_rows])
    try:
        _smoke().vocab_near_ties(h2[finite_rows], w, bias, got_f, want_f)
    except AssertionError as e:
        return err, str(e)
    return err, None


def _run_sinkhorn(case, lib, pool, gen, repeats, launch=None):
    import torch
    from vsrcic_tpu_torch.ops import sinkhorn as sk
    s, n = case.shape
    x = torch.tanh(torch.randn((s, n, n), generator=gen, device=pool.device))
    g_x = pool.input("x", x)
    out = pool.empty((s, n, n), torch.float32)
    for _ in range(repeats):
        sk._launch(lib, g_x, SINK_ITERS, SINK_TAU, out)
    torch.cuda.synchronize()
    err = float((out - sk.sinkhorn_normalize_plain(
        x, SINK_ITERS, SINK_TAU)).abs().max())
    return err, None if err <= 1e-6 else "beyond 1e-6 of the plain version"


_RUN = {"fused": _run_fused, "vocab": _run_vocab, "sinkhorn": _run_sinkhorn}


def run_case(case, lib, repeats=None, cut_bound=None, launch=None):
    """Launch `case` `repeats` times (default its own) through its launch
    function (or `launch`, of the same signature) with library `lib` on
    guarded buffers; with `cut_bound` = (kernel index, bound id), that
    bound one element short (the card tests). Returns {"case", "launches"
    {kernel: n}, "faults" [(file, Fault)] (none where `lib` is not a
    checked build), "breaches", "changed" (inputs), "max_abs_err", "error"
    (why the outputs or the launch failed, or None), "ok"}: ok when there
    is no fault, no breach, no changed input and no error."""
    import torch
    repeats = case.repeats if repeats is None else repeats
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(case.seed)
    pool = _Pool(dev)
    checked = hasattr(lib, "vsrcic_check_read")
    if checked:
        reset(lib)
    if cut_bound is not None:
        cut(lib, *cut_bound)
    err, error = None, None
    try:
        err, error = _RUN[case.op](case, lib, pool, gen, repeats, launch)
    except RuntimeError as e:
        error = "launch failed: %s" % e
    finally:
        if cut_bound is not None:
            cut(lib)
    recs = faults(lib) if checked else []
    res = {"case": case.name, "launches": case.launches(repeats),
           "faults": recs, "breaches": pool.breaches(),
           "changed": pool.changed(), "max_abs_err": err, "error": error}
    res["ok"] = not (recs or res["breaches"] or res["changed"] or error)
    return res


def tally(results):
    """{kernel: {cases, launches, faults, breaches, changed}} over run_case
    results: a case counts for every kernel it launches; a record's faults
    count for the kernel of its first fault, breaches and changed inputs
    for every kernel of the case."""
    out = {k: dict(cases=0, launches=0, faults=0, breaches=0, changed=0)
           for k in KERNELS}
    for res in results:
        for k, n in res["launches"].items():
            out[k]["cases"] += 1
            out[k]["launches"] += n
            out[k]["breaches"] += res["breaches"]
            out[k]["changed"] += len(res["changed"])
        for _, rec in res["faults"]:
            out[KERNELS[rec.kernel] if 0 <= rec.kernel < len(KERNELS)
                else KERNELS[0]]["faults"] += rec.count
    return out


def sweep(lib, seed=0, repeats=None, every=1, log=print, launch=None):
    """Run every `every`-th case of `sweep_cases(seed)` for this card
    (`repeats` launches each, default its own); with `launch` (`old_fused`)
    only the fused cases not on a forced plan, through it. Returns
    (results, tally, failures: a line for each case that is not ok)."""
    import torch
    from vsrcic_tpu_torch.ops import _build
    sms = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))
    results, failures = [], []
    cases = sweep_cases(seed, sms)[::every]
    if launch is not None:
        cases = [c for c in cases
                 if c.op == "fused" and not c.name.startswith("plan_")]
    for case in cases:
        res = run_case(case, lib, None if repeats is None
                       else max(repeats, case.repeats), launch=launch)
        results.append(res)
        if not res["ok"]:
            line = "%s: %s" % (case.name, "; ".join(
                [describe(r, f) for f, r in res["faults"]]
                + (["%d guard bytes changed" % res["breaches"]]
                   if res["breaches"] else [])
                + (["inputs changed: %s" % ", ".join(res["changed"])]
                   if res["changed"] else [])
                + ([res["error"]] if res["error"] else [])))
            failures.append(line)
            log("  MEMCHECK FAIL " + line)
    return results, tally(results), failures


def old_fused(tree):
    """(library, launch) of checkout `tree`'s fused kernel in its first
    design: its library built by its own ops/_build.py in a child process
    and loaded here; `launch` takes `_run_fused`'s arguments and calls its
    entry point (no launch plan: the kernel takes rows, B, L, M, D, A)."""
    import torch
    from vsrcic_tpu_torch.ops import _build
    path = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "from vsrcic_tpu_torch.ops import _build; print(_build.build())"
         % os.path.abspath(tree)], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vsrcic_fused_attention.argtypes = [P] * 9 + [I] * 7 + [P, P, P]
    lib.vsrcic_fused_attention.restype = I
    lib.vsrcic_error_string.argtypes = [I]
    lib.vsrcic_error_string.restype = ctypes.c_char_p

    def launch(lib, plan, item, ctrl, ha, sent_w, sent_mask, fc, att_a, det,
               proj, out, gsum):
        b, l, m, d = det.shape
        _build.check(lib.vsrcic_fused_attention(
            *(t.data_ptr() for t in (item, ctrl, ha, sent_w, sent_mask, fc,
                                     att_a, det, proj)),
            int(det.dtype == torch.bfloat16), ha.shape[0], b, l, m, d,
            proj.shape[-1], out.data_ptr(), gsum.data_ptr(),
            torch.cuda.current_stream(ha.device).cuda_stream),
            "fused_group_attention (%s)" % tree, lib)
    return lib, launch


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=None,
                    help="launches of every case (default: its own, 1 or "
                    "FULL_REPEATS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--every", type=int, default=1,
                    help="run every K-th case only")
    ap.add_argument("--old-fused", metavar="DIR",
                    help="a checkout whose fused kernel is the first "
                    "design: run it on the sweep's fused cases, guarded")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("memcheck: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vsrcic_tpu_torch.ops import _build
    t0 = time.perf_counter()
    if opt.old_fused:
        lib, launch = old_fused(opt.old_fused)
    else:
        lib, launch = _build.library(checked=True), None
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results, counts, failures = sweep(lib, opt.seed, opt.repeats, opt.every,
                                      launch=launch)
    sweep_s = time.perf_counter() - t0
    name = _smoke().card_line()
    for k, c in counts.items():
        print("%-16s cases %4d, launches %7d, faults %d, guard breaches %d, "
              "changed inputs %d" % (k, c["cases"], c["launches"],
                                     c["faults"], c["breaches"],
                                     c["changed"]), flush=True)
    summary = {"card": name, "old_fused": opt.old_fused,
               "build_seconds": build_s,
               "sweep_seconds": sweep_s, "cases": len(results),
               "repeats": opt.repeats, "by_kernel": counts,
               "failures": failures}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "memcheck.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(name)
    print(json.dumps(summary))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
