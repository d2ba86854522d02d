"""vsrcic_tpu_torch: the PyTorch/CUDA port of `vsrcic_tpu`.

A second package beside the JAX one, with the same layout and function
names. It imports torch and never JAX, nor anything of `vsrcic_tpu`; the
JAX package is the reference its tests compare against. Each Pallas kernel
of the JAX package on the ported path is a hand-written CUDA kernel for
Hopper (`csrc/`), built at first use (`ops/_build.py`) and bound with
ctypes; beside each kernel is a plain PyTorch version of the same function.

Ported so far: beam caption decode (`models.api.ControllableCaptioner.
beam_search_v` / `beam_search`), strict and fast paths; the eval pipeline
(`pipelines.EvalPipeline`); the XE and SCST captioner trainers
(`train.CaptionerXETrainer`, `train.CaptionerSCSTTrainer`) with the greedy,
sampled, forced and teacher-forced decodes they stand on (`decode.loops`);
the planner trainers (`train.SSPTrainer`, `train.SinkhornTrainer`); the
eval CLI (`python -m vsrcic_tpu_torch.cli.eval`) with the data layer
(`data`), npz checkpoints and config (`core`) and the eval metrics
(`metrics`) beneath it.
"""

__version__ = "0.1.0"
