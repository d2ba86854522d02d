"""The work of Kimi-Linear-48B-A3B's language model as a caption decoder,
counted from the configuration's shapes (`configs/vsr-kimilinear.json`),
beside `yardstick.py`'s peaks and `yardstick_vlm.py`'s MLA and expert
counts.

Work is the function's (`yardstick_vlm.py`'s rules): a product counts 2 x
M x N x K operations, each input byte is read once and each output byte
written once, only the real prefix tokens count. The chip holds 64 of the
256 experts, so an expert layer's routed work is its held pairs: `share`
below is the held pairs' share of all routed pairs (the device counts'
reading, or `held_share`'s expectation).

The KDA recurrence, per row (or token), head and key element of each value
column: the decay's product, then three multiply-adds (k . s, the update,
q . s'): 7 D^2 f32 operations a head, on the CUDA cores (67 TFLOP/s; no
tensor core runs it). Its bytes at decode: each distinct parent state a
step's rows read, read once (the beams of a job share parents: all one at
step 0), each row's own state written (D^2 x 4 a head each), q, k, g, v
in and o out (5 D x 4), beta (4); at prefill the state is written once
(it starts at 0 and stays on chip across a job's tokens) and each real
token's vectors as at decode.

`c` below is `model(cfg)`: the published keys under Kimi-VL's names
(`yardstick_vlm.py` reads them) with the KDA layers' and the captioner's.
"""
from __future__ import annotations

from vsrbench import yardstick_vlm as yv
from vsrbench.yardstick import HBM_BYTES_PER_S

F32_CUDA_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
F32 = 4


def model(cfg):
    """The configuration's published keys under the names the program and
    `yardstick_vlm` use."""
    lin = cfg["linear_attn_config"]
    c = {"vocab_size": cfg["vocab_size"], "hidden_size": cfg["hidden_size"],
         "intermediate_size": cfg["intermediate_size"],
         "moe_intermediate_size": cfg["moe_intermediate_size"],
         "num_hidden_layers": cfg["num_hidden_layers"],
         "num_attention_heads": cfg["num_attention_heads"],
         "n_shared_experts": cfg["num_shared_experts"],
         "n_routed_experts": cfg["num_experts_published"],
         "experts_held": cfg["num_experts"],
         "num_experts_per_tok": cfg["num_experts_per_token"],
         "routed_scaling_factor": cfg["routed_scaling_factor"],
         "norm_topk_prob": cfg["moe_renormalize"],
         "kv_lora_rank": cfg["kv_lora_rank"],
         "qk_nope_head_dim": cfg["qk_nope_head_dim"],
         "qk_rope_head_dim": cfg["qk_rope_head_dim"],
         "v_head_dim": cfg["v_head_dim"],
         "first_k_dense_replace": cfg["first_k_dense_replace"],
         "rms_norm_eps": cfg["rms_norm_eps"],
         "rope_theta": cfg["rope_theta"],
         "kda_layers": [i - 1 for i in lin["kda_layers"]],
         "kda_heads": lin["num_heads"], "kda_head_dim": lin["head_dim"],
         "conv_size": lin["short_conv_kernel_size"]}
    c.update(cfg["captioner"])
    return c


def held_share(c):
    """The held experts' expected share of the routed pairs (64 of 256)."""
    return c["experts_held"] / c["n_routed_experts"]


def kda_layers(c):
    return len(c["kda_layers"])


def kda_proj_macs(c):
    """A token's KDA products: W_q, W_k, W_v, W_fa, W_ga, W_b (one stacked
    product), W_fb, W_gb, W_o, and the three conv4s' taps."""
    h, nh, d, kk = (c["hidden_size"], c["kda_heads"], c["kda_head_dim"],
                    c["conv_size"])
    hd = nh * d
    return h * (3 * hd + 2 * d + nh) + 2 * d * hd + hd * h + 3 * hd * kk


def kda_recurrence_flops(c):
    """A token's (or decode row's) recurrence in one layer: 7 D^2 a head."""
    return 7 * c["kda_heads"] * c["kda_head_dim"] ** 2


def mlp_macs(c, layer, share):
    """A token's MLP at `layer`: the dense SwiGLU, or the router (all its
    outputs), the held share of its routed experts and the shared one."""
    h = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 3 * h * c["intermediate_size"]
    return (h * c["n_routed_experts"]
            + (c["num_experts_per_tok"] * share + c["n_shared_experts"])
            * yv.expert_macs(c))


def prefill_flops(c, n_real, share):
    """The prefill of jobs with `n_real` real detections each: the
    projector, the MLA layers over the real tokens (causal), the KDA
    layers' products and recurrence, every MLP."""
    h, nh, dn, dr, dv, r = yv._dims(c)
    flops = 0.0
    for n in n_real:
        flops += 2.0 * n * yv.projector_macs(c)
        pairs = n * (n + 1) // 2
        for layer in range(c["num_hidden_layers"]):
            flops += 2.0 * n * mlp_macs(c, layer, share)
            if layer in c["kda_layers"]:
                flops += n * (2.0 * kda_proj_macs(c)
                              + kda_recurrence_flops(c))
            else:
                flops += 2.0 * (n * yv.attn_proj_macs(c)
                                + pairs * nh * (dn + dr + dv))
    return flops


def decode_flops(c, n_real, beam, share):
    """A beam decode: `beam` rows a job at each of seq_len steps, each
    through every layer (MLA in the absorbed form over the context so
    far), the word head and the gate head."""
    layers = c["num_hidden_layers"]
    mlp = sum(mlp_macs(c, i, share) for i in range(layers))
    head = c["hidden_size"] * (c["vocab_size"] + 2)
    lk = kda_layers(c)
    kda = lk * (2.0 * kda_proj_macs(c) + kda_recurrence_flops(c))
    flops = 0.0
    for n in n_real:
        for t in range(c["seq_len"]):
            flops += beam * (2.0 * ((layers - lk)
                                    * yv.attn_decode_macs(c, n + t + 1)
                                    + mlp + head) + kda)
    return flops


def _bound(flops, nbytes):
    return max(flops / F32_CUDA_FLOPS, nbytes / HBM_BYTES_PER_S)


def kda_prefill_bound_s(c, n_real):
    """Least time of a prefill's recurrence calls, one a KDA layer: the
    jobs' states written once, each real token's vectors in and out, or
    its operations on the CUDA cores; per call the larger."""
    nh, d = c["kda_heads"], c["kda_head_dim"]
    tokens = sum(n_real)
    nbytes = F32 * nh * (len(n_real) * d * d + tokens * (5 * d + 1))
    return kda_layers(c) * _bound(tokens * kda_recurrence_flops(c), nbytes)


def kda_decode_bound_s(c, rows, parents):
    """Least time of a beam decode's recurrence calls, one a KDA layer and
    step, each over `rows` rows: the `parents` distinct parent states its
    steps read (summed over the steps; the program's device count
    `kda_parents` a decode), read once, each row's own state written, its
    vectors in and out; or its operations. Per layer the larger of the
    steps' summed bytes and operations: no more than the steps' least
    times added."""
    nh, d = c["kda_heads"], c["kda_head_dim"]
    steps = c["seq_len"]
    nbytes = F32 * nh * (parents * d * d
                         + steps * rows * (d * d + 5 * d + 1))
    return kda_layers(c) * _bound(steps * rows * kda_recurrence_flops(c),
                                  nbytes)

