"""vocab_head_roofline_pct.eval: the vocab head's least time over its
device time, in the traced slice. The least time of a call is the
function's (`yardstick.vocab_head_bound_s`: one product over the bf16
peak, or h2, the table read once and the outputs over HBM), whatever route
computes it; calls are the wrapper's `launches` counter over the slice;
device time is the summed time of the operations whose names start with
PREFIXES (the split pass, the tile kernels and the merge)."""

from vsrbench import yardstick as ys

PREFIXES = ("vocab_",)


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.counters or not sl.counters.get("vocab"):
        return None
    ms, _ = sl.device_ms(PREFIXES)
    if not ms:
        return None
    c, prog = ctx.config["captioner"], ctx.config["program"]
    rows = ctx.shape["items"] * ctx.shape["beam"]
    table = 4 if prog["table_dtype"] == "float32" else 2
    bound = sl.counters["vocab"] * ys.vocab_head_bound_s(
        rows, c["rnn_size"], c["vocab_size"], ctx.shape["beam"], 4, table)
    return 100.0 * bound / (ms / 1e3)
