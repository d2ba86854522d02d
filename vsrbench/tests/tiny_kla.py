"""The Kimi-Linear cell's files at tiny shapes, for runs on the CPU."""
from __future__ import annotations

from vsrbench.tests.tiny import _dump, _load, tiny_root

CELL = "vsr-kimilinear.kda-stream-b128"
TINY = dict(vocab_size=50, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=6,
            num_attention_heads=4, num_shared_experts=1, num_experts=8,
            num_experts_published=16, num_experts_per_token=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16)
LINEAR = dict(kda_layers=[1, 2, 3, 5], full_attn_layers=[4, 6], num_heads=4,
              head_dim=16, short_conv_kernel_size=4)


def tiny_kla_root(root):
    """`tiny.tiny_root` (vsr-coco's plan at tiny shapes) with the
    Kimi-Linear configuration, traffic and limits: the decoder at the CPU
    tests' size (hidden 64; one dense layer, then KDA, KDA, KDA, MLA, KDA,
    MLA; 4 KDA heads of 16; 16 routed experts, 8 held, top 4, 1 shared),
    float32 weights."""
    root = tiny_root(root)
    c = _load("vsrbench", "configs", "vsr-kimilinear.json")
    coco = _load(root, "vsrbench", "configs", "vsr-coco.json")
    c.update(TINY)
    c["linear_attn_config"] = dict(LINEAR)
    c["captioner"].update(seq_len=6, det_feat_size=16)
    for k in ("planner", "sinkhorn", "plan"):
        c[k] = coco[k]
    c["weights"].update(dtype="float32", std=0.2, router_bias_std=0.05)
    _dump(c, root, "vsrbench", "configs", "vsr-kimilinear.json")
    t = _load("vsrbench", "traffic", "kda-stream-b128.json")
    t.update(jobs=6, pool=2, trace_wait=1, trace_units=2, check_batches=2,
             judge_block=3, real_detections=[3, 7],
             regions_per_group=[1, 4])
    _dump(t, root, "vsrbench", "traffic", "kda-stream-b128.json")
    _dump(_load("vsrbench", "limits", CELL + ".json"), root, "vsrbench",
          "limits", CELL + ".json")
    return root
