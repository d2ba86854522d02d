"""Split the vocab kernel's TMA routes into their parts on one card.

    python3 vsrcic_tpu_torch/tools/vocab_split.py

Builds variants of `csrc/vocab_topk.cu`'s `vocab_tma_kernel` from edited
copies of the source (each with nvcc, `_build.NVCC_FLAGS`, into
`vsrcic_tpu_torch/build/split/`) and times stage 1 of each under the
profiler (`chip_smoke.kernel_split`) at the beam's shape (rows 5120, R
1000, V 10000, k 5) on each of its routes, with the launch plans the
wrapper picks for "bf16" (bf16 h2 and table, `VSRCIC_VOCAB_LHS_BF16=1`),
"split" (an f32 h2 on the bf16 table, the beam's default: the three bf16
planes of `split_bf16x3`, made once by the checkout's own split pass),
"split9" (the f32 h2 on the f32 table: h2's planes times W_t's, made once
by `table_planes`) and "split_w" (bf16 h2 on the f32 table):

  full        the kernel as it is
  no_rounds   the fold without its top-k rounds (max, sum, keys)
  no_fold     the products and copies, no fold
  loads_only  the copies alone: no products, no fold
  mma_only    the products alone: the producer arrives without copying

Only `full` computes the function; the others exist to be timed. Each
edit is asserted to apply, so a change to the source that moves an edited
line stops the tool rather than timing the wrong thing. Prints one line
per variant and writes `chiprun_out/vocab_split.json` beside the card's
name and power limit.
"""
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(REPO, "vsrcic_tpu_torch", "csrc", "vocab_topk.cu")

FOLD = ("  if (v0 + BN <= V) {\n"
        "    add_bias<true, BN>(")
ROUNDS = "  for (int q = 0; q < k; ++q) {\n    int bk[2], bc[2];"
MMA = "            wgmma_tile<BN>(\n"
LOAD_FROM = "          mbar_expect_tx(&full[s], STAGE);"
LOAD_TO = "        }\n      }\n      // the last `stages` positions"


def _edit(src, old, new):
    if src.count(old) != 1:
        raise SystemExit("vocab_split: the source no longer holds %r once"
                         % old.splitlines()[0])
    return src.replace(old, new)


def variants(src):
    # keep d live without folding: the products must not be optimised away
    no_fold = _edit(src, FOLD, "  if (lane == 0 && acc[0] == 12345.f) "
                    "part_m[0] = acc[3];\n  if (0)\n" + FOLD)
    i, j = no_fold.index(LOAD_FROM), no_fold.index(LOAD_TO)
    return {
        "full": src,
        "no_rounds": _edit(src, ROUNDS, ROUNDS.replace("q < k", "q < 0")),
        "no_fold": no_fold,
        "loads_only": _edit(no_fold, MMA, "            if (0)\n" + MMA),
        "mma_only": (no_fold[:i] + "          mbar_expect_tx(&full[s], 0);\n"
                     + no_fold[j:]),
    }


def build(name, src, out_dir, nvcc, flags):
    cu = os.path.join(out_dir, "vocab_%s.cu" % name)
    so = os.path.join(out_dir, "libvocab_%s.so" % name)
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run(
        [nvcc, *flags, "-I", os.path.dirname(SRC), "-shared", "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise SystemExit("vocab_split: nvcc failed on %s\n%s"
                         % (name, res.stdout))
    return so


def main():
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from vsrcic_tpu_torch.ops import _build
    from vsrcic_tpu_torch.ops import vocab_topk as vt
    if not torch.cuda.is_available():
        raise SystemExit("vocab_split: needs a CUDA card")
    card = smoke.card_line()
    print(card, flush=True)
    out_dir = os.path.join(_build.BUILD, "split")
    os.makedirs(out_dir, exist_ok=True)
    with open(SRC) as f:
        srcs = variants(f.read())
    fns = {}
    for name, src in srcs.items():
        fn = ctypes.CDLL(build(name, src, out_dir, _build._nvcc(),
                               _build.NVCC_FLAGS)).vsrcic_vocab_topk_bf16
        fn.argtypes = _build.SIGNATURES["vsrcic_vocab_topk_bf16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, r, v, k = smoke.ROWS, smoke.RNN, smoke.VOCAB, smoke.BEAM
    h2 = torch.tanh(torch.randn((rows, r), generator=gen, device=dev))
    wf = (torch.randn((r, v), generator=gen, device=dev)
          * (2.0 / (r + v)) ** 0.5)
    w = wf.bfloat16()
    w_planes = vt.table_planes(wf)
    b = 0.01 * torch.randn((v,), generator=gen, device=dev)
    sms = _build.sm_count(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    plans = {}
    for route, lhs, table in (("bf16", h2.bfloat16(), w),
                              ("split", h2, w), ("split9", h2, wf),
                              ("split_w", h2.bfloat16(), wf)):
        plan = vt.vocab_launch_plan(rows, r, v, k, lhs.dtype, table.dtype,
                                    True, sms)
        plans[route] = (lhs, table, vt.vocab_launch_plan(
            rows, r, v, k, lhs.dtype, table.dtype, True, sms,
            vt.resident_clusters(dev, plan.stages, plan.planes,
                                 plan.w_planes)))
    out = {"card": card, "shape": [rows, r, v, k], "plans": {},
           "stage1_ms": {}}
    for route, (lhs, table, plan) in plans.items():
        ops = vt.split_bf16x3(lhs) if plan.planes > 1 else lhs
        rhs = w_planes if plan.w_planes > 1 else table
        n_t = math.ceil(v / plan.tile_n)
        bufs = [torch.empty((rows, n_t, k), dtype=f32, device=dev),
                torch.empty((rows, n_t, k), dtype=torch.int32, device=dev),
                torch.empty((rows, n_t), dtype=f32, device=dev),
                torch.empty((rows, n_t), dtype=f32, device=dev),
                torch.empty((rows, k), dtype=f32, device=dev),
                torch.empty((rows, k), dtype=torch.int32, device=dev),
                torch.empty((rows, 1), dtype=f32, device=dev)]
        want = vt.vocab_topk_lse_plain(lhs, table, b, k)
        out["plans"][route] = {"stages": plan.stages,
                               "cluster": plan.cluster, "grid": plan.grid,
                               "planes": [plan.planes, plan.w_planes]}
        out["stage1_ms"][route] = {}
        for name, fn in fns.items():
            def call():
                err = fn(ops.data_ptr(), rhs.data_ptr(), b.data_ptr(), rows,
                         r, v, rhs.shape[-1], k, 1, plan.tile_n, plan.planes,
                         plan.w_planes, plan.stages, plan.cluster, plan.grid,
                         plan.smem_bytes,
                         *[t.data_ptr() for t in bufs],
                         torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise SystemExit("vocab_split: %s %s refused: %d"
                                     % (route, name, err))
            call()
            torch.cuda.synchronize()
            if name == "full" and not all(
                    torch.allclose(g, w_, rtol=1e-5, atol=1e-6)
                    for g, w_ in ((bufs[4], want[0]), (bufs[6], want[2]))):
                raise SystemExit("vocab_split: the full %s kernel disagrees "
                                 "with the plain version" % route)
            ms = smoke.kernel_split(call, "vocab_tma").get(
                "vocab_tma_kernel")
            out["stage1_ms"][route][name] = ms
            print("  %-16s %-10s stage 1 %.4f ms" % (route, name, ms),
                  flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "vocab_split.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
