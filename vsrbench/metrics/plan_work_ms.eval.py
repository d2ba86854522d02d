"""plan_work_ms.eval: host milliseconds a batch of the eval pipeline's plan
work, the program's spans `eval.plan_dispatch`, `eval.plan_finish` and
`eval.recons` less the waits inside them (`eval.plan_wait`), over the
window's batches. With plan_wait_ms.eval it makes up plan_host_ms.eval,
timed from inside the program."""

from vsrbench import program_spans as ps

SPANS = ("eval.plan_dispatch", "eval.plan_finish", "eval.recons")


def read(ctx):
    spans = ps.window_spans(ctx)
    if spans is None:
        return None
    return (ps.total_ms(spans, SPANS)
            - ps.waits_under_ms(spans, SPANS)) / ctx.units
