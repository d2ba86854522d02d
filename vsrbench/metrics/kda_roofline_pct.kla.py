"""kda_roofline_pct.kla: the KDA recurrence kernel's share of its roofline
in the traced slice: the least time of the slice's recurrence calls over
the device time of the operations whose names start with PREFIXES
(`kda_recurrence_kernel`, in the prefill's launches and the decode
layers' CUDA graph replays alike).

The least time (`yardstick_kla.py`) of each traced batch, its prefill's
calls and its decode's taken apart and added: a call's bytes over HBM
(at decode each distinct parent state read once, the decoder's device
count `kda_parents` over the slice, and each row's own written; at
prefill each job's written once; each position's q, k, g, v, beta in and
o out) or its 7 D^2 f32 operations a head over the CUDA cores, the
larger. The traced batches follow the window's in the pool's order. None
where the slice has no such operation or count (a program without the
kernel)."""

from vsrbench import yardstick_kla as yk

PREFIXES = ("kda_",)


def read(ctx):
    sl = ctx.slice
    pool = getattr(ctx, "pool", None)
    if sl is None or not pool:
        return None
    ms, _ = sl.device_ms(PREFIXES)
    parents = (sl.counters or {}).get("kda_parents")
    if not ms or not parents:
        return None
    c = yk.model(ctx.config)
    tr = ctx.traffic
    units = tr["trace_units"]
    rows = tr["jobs"] * ctx.shape["beam"]
    first = ctx.units + tr["trace_wait"] + 1
    least = 0.0
    for j in range(units):
        n_real = pool[(first + j) % len(pool)].n_real
        least += yk.kda_prefill_bound_s(c, n_real) + yk.kda_decode_bound_s(
            c, rows, parents / units)
    return 100.0 * least / (ms / 1e3)
