"""moe_roofline_pct.kla: `moe_roofline_pct.vlm`'s share at this model's
widths (2304 x 1024 experts, one shared): the traced slice's expert
products' least time over the device time of the operations that the
`vlm.moe` spans launched. Pairs and experts hit are the decoder's device
counts, which count the held experts only (64 of the 256 the router
spans); the shared expert's rows and the calls come from the shapes.
None where the slice has no such span or count."""

from vsrbench import yardstick_kla as yk
from vsrbench import yardstick_vlm as yv


def read(ctx):
    sl = ctx.slice
    ms = (getattr(ctx, "span_ms", None) or {}).get("vlm.moe")
    n = sl.counters if sl is not None else None
    if not ms or not n or "decode_pairs" not in n:
        return None
    c = yk.model(ctx.config)
    tr = ctx.traffic
    units = tr["trace_units"]
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    calls = units * c["seq_len"] * layers
    rows = tr["jobs"] * ctx.shape["beam"]
    least = (yv.moe_bound_s(c, n["prefill_pairs"], n["prefix_tokens"]
                            * layers, n["prefill_experts_hit"],
                            units * layers)
             + yv.moe_bound_s(c, n["decode_pairs"], rows * calls,
                              n["decode_experts_hit"], calls))
    return 100.0 * least / (ms / 1e3)
