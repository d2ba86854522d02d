"""step_products_roofline_pct.xe: XE's products' least time over their
kernels' device time, in the traced slice.

The least time is the function's, whatever route computes it: the
products the lean loss takes through the step products' autograd function
on the card, from the configuration's shapes, over each traced step. At
each of `seq_len` steps of each of the batch's rows: the step's grouped
products and word head (`yardstick.step_macs` at no regions) and the
att_va projection of the group's `regions` regions; once a row: the image
columns of the first products (D x 6R). Each is counted for the forward
and for each of its gradients: the forward, the checkpointed step's
recompute (not the image columns, projected once a loss), dA (neither
att_va's nor the image columns': their A is the data) and dW. Two
operations a multiply-add over the tensor cores' bf16 peak: one pass,
where the kernels make nine, so the share stays under ~11%. The device time
is the summed time of the operations whose names start with PREFIXES (the
products, their gradients and the split passes). None where the slice has
no such operation, as where the step runs its products through cuBLAS."""

from vsrbench import yardstick as ys

PREFIXES = ("step_planes_",)


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.units:
        return None
    ms, _ = sl.device_ms(PREFIXES)
    if not ms:
        return None
    c = ctx.config["captioner"]
    r, d, a = c["rnn_size"], c["det_feat_size"], c["att_size"]
    batch = ctx.traffic["batch"]
    rows = batch * c["seq_len"]
    steps = rows * ys.step_macs(c, 0, False)
    regions = rows * ctx.config["data"]["regions"] * d * a
    image = batch * d * 6 * r
    macs = sl.units * (4 * steps + 3 * regions + 2 * image)
    return 100.0 * 2.0 * macs / ys.BF16_DENSE_FLOPS / (ms / 1e3)
