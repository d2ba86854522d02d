"""plan_wait_ms.eval: host milliseconds a batch in which the eval pipeline
only waits for its plan's copies (the program's span `eval.plan_wait`
inside `plan_finish`), over the window's batches."""

from vsrbench import program_spans as ps


def read(ctx):
    spans = ps.window_spans(ctx)
    if spans is None:
        return None
    return ps.total_ms(spans, ("eval.plan_wait",)) / ctx.units
