"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].  2 shared experts per the model card.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe_experts=64,
    moe_top_k=6,
    moe_shared_experts=2,
    moe_d_ff=1408,
)
