"""moe_roofline_pct.vlm: the traced slice's expert products' least time
over the device time of the operations that the `vlm.moe` spans launched
(the router, the sort, the grouped products, the shared experts, the
weighted sum).

The least time (`yardstick_vlm.moe_bound_s`), taken for the prefill's and
the decode's calls apart and added: the routed pairs and the shared
experts' rows at 3 x 2048 x 1408 multiply-adds a pair over the bf16 peak,
or the weights of the experts that took a token and the shared experts'
once a call, with each pair's and row's activations, over HBM. Pairs,
experts hit and real prefix tokens are the decoder's device counts over
the slice; the decode's rows and calls come from the shapes. None where
the slice has no such span or count."""

from vsrbench import yardstick_vlm as yv


def read(ctx):
    sl = ctx.slice
    ms = (getattr(ctx, "span_ms", None) or {}).get("vlm.moe")
    n = sl.counters if sl is not None else None
    if not ms or not n or "decode_pairs" not in n:
        return None
    c = yv.model(ctx.config)
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
