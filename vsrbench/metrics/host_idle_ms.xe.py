"""host_idle_ms.xe: device idle milliseconds a traced XE step while the
host is in the step's own work: idle instants of the traced slice whose
innermost program span is `xe.step` or one of its spans other than the
wait `train.readback` (`vsrbench/program_spans.py`)."""

from vsrbench import program_spans as ps


def read(ctx):
    return ps.host_idle_ms(ctx, root="xe.step")
