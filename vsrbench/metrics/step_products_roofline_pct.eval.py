"""step_products_roofline_pct.eval: the candidate step's f32 products'
least time over their kernels' device time, in the traced slice.

The least time is the function's, whatever route computes it: each traced
batch's beam rows (items x beam) at every step, times the products of a
step without the vocab head (`yardstick.step_macs` at no regions, less
R x V), plus each item's image columns of the first projections (D x 6R,
once a decode), at two operations a multiply-add over the tensor cores'
bf16 peak. The device time is the summed time of the operations whose
names start with PREFIXES (the products and their split pass). None where
the slice has no such operation, as where the step runs its products
through cuBLAS."""

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
    r, d = c["rnn_size"], c["det_feat_size"]
    items = sl.units * ctx.shape["items"]
    macs = (items * ctx.shape["beam"] * c["seq_len"]
            * (ys.step_macs(c, 0, False) - r * c["vocab_size"])
            + items * d * 6 * r)
    return 100.0 * 2.0 * macs / ys.BF16_DENSE_FLOPS / (ms / 1e3)
