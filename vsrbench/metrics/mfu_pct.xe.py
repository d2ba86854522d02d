"""mfu_pct.xe: XE model operations over the window's seconds, as a share
of the card's dense bf16 peak. A step's operations are the teacher-forced
forward at the configuration's shapes and its backward, 3 x the forward
(`yardstick.xe_step_flops`); the checkpointed loss's recomputation is not
counted."""

from vsrbench import yardstick as ys


def read(ctx):
    if not ctx.units or not ctx.window_s:
        return None
    c = ctx.config["captioner"]
    flops = ys.xe_step_flops(c, ctx.traffic["batch"], c["seq_len"],
                             ctx.config["data"]["regions"])
    return 100.0 * ctx.units * flops / (ctx.window_s * ys.BF16_DENSE_FLOPS)
