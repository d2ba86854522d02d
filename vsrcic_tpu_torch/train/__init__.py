"""See the counterpart package `vsrcic_tpu.train`: the captioner trainers (XE,
SCST) and the planner trainers (S-SSP, Sinkhorn)."""
from vsrcic_tpu_torch.train.common import (  # noqa: F401
    Adam, TrainState, adam, planner_lr, set_learning_rate, step_lr)
from vsrcic_tpu_torch.train.captioner import (  # noqa: F401
    CaptionerSCSTTrainer, CaptionerXETrainer, scst_loss_fn, xe_loss_fn)
from vsrcic_tpu_torch.train.planners import (  # noqa: F401
    SSPTrainer, SinkhornTrainer, sinkhorn_loss_fn, sinkhorn_pairs_from_grids)
