"""The Kimi-VL cell's files at tiny shapes, for runs on the CPU."""
from __future__ import annotations

from vsrbench.tests.tiny import _dump, _load, tiny_root

CELL = "vsr-kimivl.vlm-stream-b256"
TINY = dict(vocab_size=50, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)


def tiny_vlm_root(root):
    """`tiny.tiny_root` (vsr-coco's plan at tiny shapes) with the Kimi-VL
    configuration, traffic and limits: the decoder at the CPU tests' size
    (hidden 64, 4 heads, latent 32, RoPE 8, 8 experts, top 2, 1 shared,
    1 dense and 2 MoE layers), float32 weights."""
    root = tiny_root(root)
    c = _load("vsrbench", "configs", "vsr-kimivl.json")
    coco = _load(root, "vsrbench", "configs", "vsr-coco.json")
    c.update(TINY)
    c["captioner"].update(seq_len=6, det_feat_size=16)
    for k in ("planner", "sinkhorn", "plan"):
        c[k] = coco[k]
    c["weights"].update(dtype="float32", std=0.2, router_bias_std=0.05)
    _dump(c, root, "vsrbench", "configs", "vsr-kimivl.json")
    t = _load("vsrbench", "traffic", "vlm-stream-b256.json")
    t.update(jobs=6, pool=2, trace_wait=1, trace_units=2, check_batches=2,
             judge_block=3, real_detections=[3, 7],
             regions_per_group=[1, 4])
    _dump(t, root, "vsrbench", "traffic", "vlm-stream-b256.json")
    _dump(_load("vsrbench", "limits", CELL + ".json"), root, "vsrbench",
          "limits", CELL + ".json")
    return root
