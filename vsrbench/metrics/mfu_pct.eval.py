"""mfu_pct.eval: the eval stream's model operations over the window's
seconds, as a share of the card's dense bf16 peak. A batch's operations
are counted from the configuration's shapes (`yardstick.py`): the beam's
rows (jobs x beam) at every step, each item's step-invariant products, the
S-SSP planner over the batch's verb groups and the Sinkhorn network over
its ambiguous pairs."""

from vsrbench import yardstick as ys


def batch_flops(cfg, shape):
    c, plan = cfg["captioner"], cfg["plan"]
    return (ys.beam_batch_flops(c, shape["items"], shape["beam"],
                                c["seq_len"], plan["fixed_len"],
                                plan["regions"])
            + ys.ssp_flops(cfg["planner"], shape["groups"],
                           shape["planner_tokens"], shape["planner_steps"])
            + ys.sinkhorn_flops(cfg["sinkhorn"], shape["groups"],
                                shape["pairs"]))


def read(ctx):
    if not ctx.units or not ctx.window_s:
        return None
    return (100.0 * ctx.units * batch_flops(ctx.config, ctx.shape)
            / (ctx.window_s * ys.BF16_DENSE_FLOPS))
