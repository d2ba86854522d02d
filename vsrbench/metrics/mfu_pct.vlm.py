"""mfu_pct.vlm: the Kimi-VL eval stream's model operations over the
window's seconds, as a share of the card's dense bf16 peak. A batch's
operations are counted from its shapes (`yardstick_vlm.py`): the prefill
over each job's real detections, every beam row's decode steps through
all layers and the heads, the control tokens, and the plan's networks
(`yardstick.py`). The window's batches cycle the pool in order."""

from vsrbench import yardstick as ys


def read(ctx):
    pool = getattr(ctx, "pool", None)
    if not pool or not ctx.units or not ctx.window_s:
        return None
    flops = sum(pool[i % len(pool)].flops for i in range(ctx.units))
    return 100.0 * flops / (ctx.window_s * ys.BF16_DENSE_FLOPS)
