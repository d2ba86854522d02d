"""The benchmark's plain reference: the VSR-guided captioning system in plain
PyTorch (float32, TF32 off) and NumPy/SciPy, written from the published
model (arXiv 2103.12204, the reference code's `models/` and
`coco_scripts/eval_coco.py`), with no kernel, cache or batching trick.

It imports nothing of the measured program, nothing of the JAX package and
no JAX: `vsrbench/tests/test_vsrbench_imports.py` holds it to that. It takes
the inputs and weights that the harness made and works out every derived
quantity (the planner's encodings, the Sinkhorn matrices, the plan, the
recons, the statics, Adam's state) again from them.

  * `captioner.py`: the role-shift captioner's step, the teacher-forced
    judge of served beams, and the XE loss, gradients and Adam;
  * `planner.py`: the S-SSP planner (full-buffer decoder) and the Sinkhorn
    network;
  * `plan.py`: verb groups, the Hungarian ranks, the rank merge, verb
    lists and recons, as `eval_coco.py` composes them.
"""
