"""mla_roofline_pct.vlm: the traced slice's attention layers' least time
over the device time of the operations that the `vlm.attn` spans launched
(the projections, the core over the prefix's and the beams' latents, the
norm before and the residual after).

The least time (`yardstick_vlm.py`) of each traced batch: its prefill's
attention over the real detections (causal), and its decode's, step by
step: every row's operations in the absorbed form over the bf16 peak, or
the projections' weights, the prefix latents and each row's own, read,
and its activations and new latents, over HBM. The traced batches follow
the window's in the pool's order. None where the slice has no such
span."""

from vsrbench import yardstick_vlm as yv


def read(ctx):
    ms = (getattr(ctx, "span_ms", None) or {}).get("vlm.attn")
    pool = getattr(ctx, "pool", None)
    if not ms or not pool:
        return None
    c = yv.model(ctx.config)
    tr = ctx.traffic
    first = ctx.units + tr["trace_wait"] + 1
    least = 0.0
    for j in range(tr["trace_units"]):
        n_real = pool[(first + j) % len(pool)].n_real
        least += (yv.mla_prefill_bound_s(c, n_real)
                  + yv.mla_decode_bound_s(c, n_real, ctx.shape["beam"]))
    return 100.0 * least / (ms / 1e3)
