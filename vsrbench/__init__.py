"""The benchmark of `vsrcic_tpu_torch`, the PyTorch and CUDA port: one run of
one cell a process (`python -m vsrbench.run`), driven by `BENCHMARK.json`
and the files it names under this folder (`layout.py`). It imports nothing
of JAX or of the JAX package `vsrcic_tpu`; its reference (`reference/`)
imports nothing of the program either.
"""
