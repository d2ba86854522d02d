"""See the counterpart package `vsrcic_tpu.metrics`; same exports."""
from vsrcic_tpu_torch.metrics.cider import Cider, CiderScorer  # noqa: F401
from vsrcic_tpu_torch.metrics.bleu import Bleu  # noqa: F401
from vsrcic_tpu_torch.metrics.rouge import Rouge  # noqa: F401
from vsrcic_tpu_torch.metrics.external import Meteor, Spice, ExternalMetricUnavailable  # noqa: F401
from vsrcic_tpu_torch.metrics.meteor import NativeMeteor  # noqa: F401
from vsrcic_tpu_torch.metrics.spice import NativeSpice  # noqa: F401
