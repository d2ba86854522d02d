"""host_idle_ms.eval: device idle milliseconds a traced batch while the
host is in the program's own work: idle instants of the traced slice whose
innermost program span is not a wait (`vsrbench/program_spans.py`). Idle
under a wait span, or outside every program span, is left out."""

from vsrbench import program_spans as ps


def read(ctx):
    return ps.host_idle_ms(ctx)
