"""device_idle_pct.xe: the share of the traced slice's host time (its XE
steps) in which no device operation ran: 100 minus the union of the
operations' intervals over the slice."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.window_s or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
