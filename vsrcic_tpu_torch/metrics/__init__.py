"""See the counterpart package `vsrcic_tpu.metrics` (CIDEr-D only so far)."""
from vsrcic_tpu_torch.metrics.cider import Cider, CiderScorer  # noqa: F401
