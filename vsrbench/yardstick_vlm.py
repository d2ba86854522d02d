"""The work of Kimi-VL-A3B's language model as a caption decoder, counted
from the configuration's shapes (`configs/vsr-kimivl.json`), beside
`yardstick.py`'s peaks.

Work is the function's: a product counts 2 x M x N x K operations
however a kernel computes it, each input byte is read once and each
output byte written once, and only what the inputs need is counted (the
real prefix tokens, not their padding). A decode step counts the absorbed
form it runs: W_UK folded into q, attention over the 576-wide latents of
the prefix and of the caption so far, W_UV on the latent output.

`c` below is `model(cfg)`: the configuration's published keys with its
`captioner` group.
"""
from __future__ import annotations

from vsrbench.yardstick import BF16_DENSE_FLOPS, HBM_BYTES_PER_S

BF16 = 2


def model(cfg):
    c = {k: v for k, v in cfg.items() if not isinstance(v, (dict, list))}
    c.update(cfg["captioner"])
    return c


def _dims(c):
    h, nh = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"], c["kv_lora_rank"])
    return h, nh, dn, dr, dv, r


def attn_proj_macs(c):
    """A token's attention projections: q, [c_kv; k_pe], [k_nope; v],
    o (the expanded form's)."""
    h, nh, dn, dr, dv, r = _dims(c)
    return h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) + nh * dv * h


def attn_decode_macs(c, context):
    """A decode row's attention in the absorbed form over `context`
    positions (prefix and caption, this one included): q, [c_kv; k_pe],
    q_nope W_UK, scores, the latent output, W_UV, o."""
    h, nh, dn, dr, dv, r = _dims(c)
    return (h * nh * (dn + dr) + h * (r + dr) + nh * dn * r
            + nh * context * (r + dr) + nh * context * r + nh * r * dv
            + nh * dv * h)


def expert_macs(c):
    """One routed expert on one token (gate, up, down)."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def mlp_macs(c, layer):
    """A token's MLP at `layer`: the dense SwiGLU, or the router, its
    routed experts and the shared ones."""
    h = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 3 * h * c["intermediate_size"]
    return (h * c["n_routed_experts"]
            + (c["num_experts_per_tok"] + c["n_shared_experts"])
            * expert_macs(c))


def projector_macs(c):
    h = c["hidden_size"]
    return c["det_feat_size"] * h + h * h


def prefill_flops(c, n_real):
    """The prefill of jobs with `n_real` real detections each: the
    projector, and every layer over the real tokens, causal."""
    h, nh, dn, dr, dv, r = _dims(c)
    macs = 0
    for n in n_real:
        macs += n * projector_macs(c)
        pairs = n * (n + 1) // 2
        for layer in range(c["num_hidden_layers"]):
            macs += (n * (attn_proj_macs(c) + mlp_macs(c, layer))
                     + pairs * nh * (dn + dr + dv))
    return 2.0 * macs


def decode_flops(c, n_real, beam):
    """A beam decode: `beam` rows a job at each of seq_len steps, each
    through every layer, the word head and the gate head."""
    macs = 0
    layers = c["num_hidden_layers"]
    mlp = sum(mlp_macs(c, i) for i in range(layers))
    head = c["hidden_size"] * (c["vocab_size"] + 2)
    for n in n_real:
        for t in range(c["seq_len"]):
            macs += beam * (layers * attn_decode_macs(c, n + t + 1) + mlp
                            + head)
    return 2.0 * macs


def control_flops(c, jobs, groups, regions):
    """The control tokens: every group's region slots through the
    projector."""
    return 2.0 * jobs * groups * regions * projector_macs(c)


def moe_bound_s(c, pairs, shared_rows, experts_hit, calls):
    """Least time of expert products: the routed pairs and the shared
    experts' rows (n_shared pairs' worth each) at `expert_macs` over the
    bf16 peak, or the bytes: the weights of the experts that took a token
    (`experts_hit`, summed over calls) and the shared experts' once a call,
    each pair's and shared row's input and output, over HBM."""
    h = c["hidden_size"]
    ns = c["n_shared_experts"]
    ops = 2.0 * (pairs + ns * shared_rows) * expert_macs(c)
    nbytes = BF16 * ((experts_hit + ns * calls) * expert_macs(c)
                     + (pairs + shared_rows) * 2 * h)
    return max(ops / BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)


def attn_weight_bytes(c):
    return BF16 * attn_proj_macs(c)


def mla_decode_bound_s(c, n_real, beam):
    """Least time of a beam decode's attention layers: per step and layer
    the operations of every row, or the bytes: the projections' weights,
    the prefix latents of each job and each row's own, read; each row's
    input and output, and its new latents, written."""
    h, nh, dn, dr, dv, r = _dims(c)
    layers = c["num_hidden_layers"]
    lat = r + dr
    total = 0.0
    for t in range(c["seq_len"]):
        ops = sum(2.0 * beam * layers * attn_decode_macs(c, n + t + 1)
                  for n in n_real)
        rows = beam * len(n_real)
        nbytes = BF16 * layers * (
            attn_proj_macs(c) + sum(n for n in n_real) * lat
            + rows * (t * lat + lat + 2 * h))
        total += max(ops / BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


def mla_prefill_bound_s(c, n_real):
    """Least time of the prefill's attention layers: operations over the
    real tokens (causal), or the weights once and each token's input,
    output and latents."""
    h, nh, dn, dr, dv, r = _dims(c)
    layers = c["num_hidden_layers"]
    ops = 0.0
    for n in n_real:
        ops += 2.0 * layers * (n * attn_proj_macs(c)
                               + n * (n + 1) // 2 * nh * (dn + dr + dv))
    tokens = sum(n_real)
    nbytes = BF16 * layers * (attn_proj_macs(c)
                              + tokens * (2 * h + r + dr))
    return max(ops / BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)
