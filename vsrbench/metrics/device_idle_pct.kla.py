"""device_idle_pct.kla: the share of the Kimi-Linear eval stream's traced
slice's host time (its batches, run_stream's schedule) in which no device
operation ran: 100 minus the union of the operations' intervals over the
slice."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.window_s or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
