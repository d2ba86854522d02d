"""See the counterpart package `vsrcic_tpu.pipelines`."""
from vsrcic_tpu_torch.pipelines.sr_groups import (  # noqa: F401
    VerbGroup, batch_planner_inputs, extract_verb_groups)
from vsrcic_tpu_torch.pipelines.eval_pipeline import (  # noqa: F401
    CaptionJob, EvalPipeline)
