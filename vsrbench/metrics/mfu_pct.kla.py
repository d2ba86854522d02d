"""mfu_pct.kla: the Kimi-Linear eval stream's model operations over the
window's seconds, as a share of the card's dense bf16 peak. A batch's
operations are counted from its shapes (`yardstick_kla.py`): the prefill
over each job's real detections, every beam row's decode steps through
all layers (the KDA recurrence's f32 operations among them) and the
heads, the control tokens and the plan's networks. Routed experts count
at the held pairs: their share of all routed pairs read from the traced
slice's device counts (pairs over tokens x layers x 8), else 64 / 256.
The window's batches cycle the pool in order."""

from vsrbench import yardstick as ys
from vsrbench import yardstick_kla as yk


def held_share(ctx, c):
    sl = getattr(ctx, "slice", None)
    n = getattr(sl, "counters", None) or {}
    if not n.get("prefix_tokens"):
        return yk.held_share(c)
    tr = ctx.traffic
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    tokens = (n["prefix_tokens"] + tr["trace_units"] * tr["jobs"]
              * ctx.shape["beam"] * c["seq_len"])
    return ((n["prefill_pairs"] + n["decode_pairs"])
            / (tokens * layers * c["num_experts_per_tok"]))


def read(ctx):
    pool = getattr(ctx, "pool", None)
    if not pool or not ctx.units or not ctx.window_s:
        return None
    c = yk.model(ctx.config)
    share = held_share(ctx, c)
    beam = ctx.shape["beam"]
    flops = 0.0
    for i in range(ctx.units):
        b = pool[i % len(pool)]
        flops += (yk.prefill_flops(c, b.n_real, share)
                  + yk.decode_flops(c, b.n_real, beam, share) + b.plan_flops)
    return 100.0 * flops / (ctx.window_s * ys.BF16_DENSE_FLOPS)
