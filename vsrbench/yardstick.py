"""The yardstick: the card's published peaks and the work of each function,
counted from the configuration's shapes.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at its full
power limit of 700 W (the run prints the card's own limit beside every
share).

Work is the function's, not a route's: a product counts 2 x M x N x K
operations however many passes a kernel makes of it, and each input byte is
read once and each output byte written once. Where a quantity is invariant
over decode steps (the image columns of the first projections, the groups'
attention projection in a beam), it counts once per item, as the function
needs it, not once per step.
"""
from __future__ import annotations

BF16_DENSE_FLOPS = 989e12        # tensor cores, bf16, dense
HBM_BYTES_PER_S = 3.35e12


def _widths(c):
    return (c["rnn_size"], c["input_encoding_size"], c["det_feat_size"],
            c["att_size"], c["vocab_size"])


def step_macs(c, regions, group_proj):
    """Multiply-adds of one decode row's step, without the image columns
    of the first projections: the sentinel, shift and LSTM-1 input
    products (6R outputs), the recurrent ones (5R), s_fc, the three R x A
    attention projections, W1_hg, the attention over `regions` regions
    (plus their att_va projection when `group_proj`, as teacher forcing
    needs it every step), LSTM 2 and the vocab head."""
    r, e, d, a, v = _widths(c)
    x_in = (r + e) if c["h2_first_lstm"] else e
    macs = (x_in * 6 * r + r * 5 * r + r * d + 3 * r * a + r * r
            + regions * (a + d)
            + (r + d + (d if c["img_second_lstm"] else 0)) * 4 * r
            + r * 4 * r + r * v)
    if group_proj:
        macs += regions * d * a
    return macs


def item_macs(c, groups, regions):
    """Multiply-adds an item needs once per decode: the image columns of
    the first projections (6R outputs) and the att_va projection of its
    `groups` x `regions` regions."""
    r, _, d, a, _ = _widths(c)
    return d * 6 * r + groups * regions * d * a


def beam_batch_flops(c, items, beam, seq_len, groups, regions):
    """A beam batch's model operations: every step for items x beam rows,
    plus each item's invariant products."""
    return 2.0 * (items * beam * seq_len * step_macs(c, regions, False)
                  + items * item_macs(c, groups, regions))


def xe_step_flops(c, rows, seq_len, regions):
    """An XE step's model operations: the teacher-forced forward over
    rows x seq_len steps and its backward, 3 x the forward (the
    checkpointed loss's recomputation is not counted)."""
    return 3.0 * 2.0 * (rows * seq_len * step_macs(c, regions, True)
                        + rows * item_macs(c, 0, regions))


def ssp_flops(p, groups, tokens, steps):
    """The S-SSP planner's operations for `groups` groups of `tokens` input
    roles, decoding `steps` roles each: the encoder over the tokens, then
    each step's decoder position (self-attention projections, attention
    over the steps so far and over the tokens, FF) and its role head; the
    encoder states' keys and values once per layer."""
    h, ff = p["hidden_size"], 4 * p["hidden_size"]
    enc = tokens * ((h * h if p["add_fc"] else 0)
                    + p["encoder_layers"] * (4 * h * h + 2 * h * ff
                                             + 2 * tokens * h))
    cross_kv = p["decoder_layers"] * 2 * tokens * h * h
    dec = steps * (p["decoder_layers"] * (6 * h * h + 2 * h * ff
                                          + 2 * (steps + tokens) * h)
                   + h * 26)
    return 2.0 * groups * (enc + cross_kv + dec)


def sinkhorn_flops(s, groups, pairs):
    """The Sinkhorn network's operations over `pairs` matrices of n rows:
    the row MLP (its matrix products) and the normalisation's 2 x n_iters
    passes of one add and one division an entry."""
    n = s["n"]
    mlp = n * (s["txt_dim"] * 128 + s["vis_dim"] * 512 + 512 * 128
               + (256 + s["pos_dim"]) * 256 + 256 * n)
    return pairs * (2.0 * mlp + 4.0 * s["n_iters"] * n * n)


def vocab_head_bound_s(rows, r, v, k, h2_bytes, table_bytes):
    """Least time of one vocab head call (top-k and log-sum-exp of
    h2 (rows, R) @ W (R, V) + b): its one product over the tensor cores'
    bf16 rate, or its bytes (h2, the table read once, the f32 bias, the
    k values, k ids and the log-sum-exp a row) over the HBM rate."""
    t_ops = 2.0 * rows * r * v / BF16_DENSE_FLOPS
    nbytes = (rows * r * h2_bytes + r * v * table_bytes + v * 4
              + rows * (2 * k + 1) * 4)
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
