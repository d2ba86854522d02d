"""vocab_head_roofline_pct.vlm: the Kimi-VL decoder's word head's least
time over its device time, in the traced slice. The head is the vocab op
on the final normed hidden and the head table, both in the weights' dtype
(bf16: the "tma" route, `vocab_tma_kernel` and its merge). The least time
of a call is the function's (`yardstick.vocab_head_bound_s`: one product
of the beam's rows x hidden x V over the bf16 peak, or the hidden, the
table read once and the outputs over HBM), whatever route computes it;
calls are the wrapper's `launches` counter over the slice; device time is
the summed time of the operations whose names start with PREFIXES. None
where the slice has no such operation or count."""

from vsrbench import yardstick as ys
from vsrbench import yardstick_vlm as yv

PREFIXES = ("vocab_",)


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.counters or not sl.counters.get("vocab"):
        return None
    ms, _ = sl.device_ms(PREFIXES)
    if not ms:
        return None
    c = yv.model(ctx.config)
    width = 2 if ctx.config["weights"]["dtype"] == "bfloat16" else 4
    k = ctx.shape["beam"]
    bound = sl.counters["vocab"] * ys.vocab_head_bound_s(
        ctx.shape["items"] * k, c["hidden_size"], c["vocab_size"], k, width,
        width)
    return 100.0 * bound / (ms / 1e3)
