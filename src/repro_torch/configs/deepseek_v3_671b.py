"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8)
[arXiv:2412.19437].  MLA ranks from the public config: q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.  (MTP omitted: the MTP
head is an auxiliary loss, not a serving-path component.)
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe_experts=256,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_d_ff=2048,
)
