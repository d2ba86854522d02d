"""plan_host_ms.eval: host milliseconds a batch inside the eval pipeline's
plan calls (`plan_dispatch`, `plan_finish`, `_build_recons`), from the
harness's spans around the pipeline instance's methods, over the window's
batches. `plan_finish` includes its wait for the plan's copies."""

SPANS = ("plan_dispatch", "plan_finish", "_build_recons")


def read(ctx):
    if not ctx.units:
        return None
    t0, t1 = ctx.window
    return 1e3 * ctx.spans.total(SPANS, t0, t1) / ctx.units
