"""See the counterpart package `vsrcic_tpu.train` (the captioner trainers so
far)."""
from vsrcic_tpu_torch.train.common import (  # noqa: F401
    Adam, TrainState, adam, planner_lr, set_learning_rate, step_lr)
from vsrcic_tpu_torch.train.captioner import (  # noqa: F401
    CaptionerSCSTTrainer, CaptionerXETrainer, scst_loss_fn, xe_loss_fn)
